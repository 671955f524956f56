"""Compute ops: optical-flow search, flow blur, frame warp.

- ``oracle``   : trusted NumPy transliteration of the reference OpenCL kernel
                 semantics (reference: video/filter/HopperRender/Kernels/*.cl).
                 Slow, used only by tests as the golden model.
- ``flow``     : JAX (jit/XLA) implementation of the hierarchical delta-sum
                 search + argmin + offset commit + blur.
- ``warp``     : JAX bidirectional warp + blend + output modes + levels.
"""
