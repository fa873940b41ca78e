"""dsmnet_tpu_torch — the PyTorch/CUDA port of ``dsmnet_tpu`` (NVIDIA H100).

The JAX package stays the reference; this package imports ``torch`` and
nothing of JAX or ``dsmnet_tpu``.  It serves every model of the JAX zoo
(PSMNet, PSMNet-basic, GCNet, DispNet, DispNetC, iResNet) and trains
PSMNet with the supervised step, with hand-written CUDA kernels
(``csrc/``, A–J) for the ten functions the JAX package runs as Pallas
kernels.  Entry points run on CUDA unless given ``device="cpu"``.
"""

__version__ = "0.1.0"
