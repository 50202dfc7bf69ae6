"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors ``repro``'s module names; imports ``torch`` and numpy, never JAX and
never ``repro``.  Plain tensor code is PyTorch; each Pallas kernel of the
JAX package on the ported path has a hand-written CUDA C++ counterpart in
``kernels/csrc`` (built at first use by ``kernels/_build.py``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
