"""The harness: the cell's files found by name, the window, the traced
run's hooks and trace reduction, and the comparison that decides
``correct``. Nothing here imports the port at module level."""
