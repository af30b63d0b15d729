"""hcrag_tpu_torch — the hybrid knowledge-graph + RAG query engine in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of `hcrag_tpu` (JAX/Pallas), which stays beside it as the reference:
module paths and public names follow it.  Entry points run on
``torch.device("cuda")`` unless the caller passes ``device="cpu"``.
"""

from hcrag_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
