"""lpr_tpu_torch — the PyTorch/CUDA port of ``lpr_tpu`` for NVIDIA Hopper.

The package mirrors ``lpr_tpu``'s layout module for module; the JAX package
stays the reference that every part of this port is tested against.  This
package imports ``torch`` and numpy only: never ``jax``, never ``lpr_tpu``.

Entry points (:class:`~lpr_tpu_torch.pipeline.recognizer.PlateRecognizer`,
:class:`~lpr_tpu_torch.serve.server.InferenceServer` and the checkpoint
loaders) run on the CUDA device unless the caller passes ``device="cpu"``.
"""

from lpr_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
