"""CPU tests of the port benchmark (`python -m pytest port_bench/tests`)."""
