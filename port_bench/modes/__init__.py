"""What a cell drives, one module a mode (`enhance`, `train`), found by
the name in the cell's traffic file."""
