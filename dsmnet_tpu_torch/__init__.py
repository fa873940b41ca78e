"""dsmnet_tpu_torch — the PyTorch/CUDA port of ``dsmnet_tpu`` (NVIDIA H100).

The JAX package stays the reference; this package imports ``torch`` and
nothing of JAX or ``dsmnet_tpu``.  Its first slice serves PSMNet
(stacked hourglass) inference, with hand-written CUDA kernels
(``csrc/``) for the four convolutions the JAX package runs as Pallas
kernels on that path.  Entry points run on CUDA unless given
``device="cpu"``.
"""

__version__ = "0.1.0"
