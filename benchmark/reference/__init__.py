"""The plain reference that decides ``correct``: float32 PyTorch and numpy
only, independent of the program under test."""
