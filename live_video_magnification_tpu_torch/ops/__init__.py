"""Numeric core of the port: plain PyTorch ops with the reference's OpenCV
semantics, and in ``hopper/`` the hand-written CUDA kernels that carry the
pyramid stencils on the card."""
