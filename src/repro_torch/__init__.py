"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The port imports neither JAX nor ``repro``: what it needs of the JAX
package's framework-free modules it keeps as its own copy. Module names follow
``repro`` so each piece's counterpart is easy to find. Entry points run on
``cuda`` unless the caller asks for ``cpu``; the CUDA kernels under
``repro_torch.kernels`` are built with ``nvcc`` at first use.
"""
