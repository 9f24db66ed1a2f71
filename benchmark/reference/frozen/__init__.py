"""Frozen copies of the port's model and geometry code, the plain
reference's building blocks.

Each file is the port's module of the same role as it stood when the
benchmark was written, with its imports pointed here, its kernels written
as the plain math they compute (the ConvRefiner's hidden blocks as
depthwise conv, BatchNorm, ReLU and 1x1 conv) and its training paths
removed. Nothing here imports the port, so a later change to the port
cannot move the yardstick it is held to.
"""
