"""Plain PyTorch references of the benchmark's configurations: one module
a family (`<family>.py`), found by name. They import nothing of the port
and take only the benchmark's own inputs: its state_dict and waveforms."""
