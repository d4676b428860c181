"""Operation and byte counts, one module a family (`<family>.py`)."""
