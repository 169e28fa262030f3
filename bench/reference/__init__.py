"""The plain reference: the dense sliding-window output of a net from its
layer list, in plain PyTorch, and the comparison that decides ``correct``.
It imports nothing of the program under test."""
