"""MC-PILCO in PyTorch for one NVIDIA H100: the port of ``mcpilco_tpu``.

The package mirrors ``mcpilco_tpu``'s module paths and class names, so each
counterpart sits at the same relative path.  It imports ``torch`` and never
``jax``; parameters keep the JAX pytree nesting (a dict per kernel, a tuple of
them for ``Sum``, a leading head axis G) so they convert leaf by leaf
(``utils/convert.py``).  The GP-predict hot op runs two hand-written CUDA
kernels (``csrc/fused_predict.cu``) whenever its tensors lie on the card.
"""

import torch


def disable_tf32() -> None:
    """Force full-fp32 matmuls and convolutions.

    The GP posterior algebra cancels heavily: alpha entries of O(1e2) sum to
    O(0.1) means, and the variance factor's O(1e2) entries contract k* to
    O(1e-2).  TF32 keeps ~3 decimal digits, which corrupts the rollout and
    stops learning (RESULTS.md, numerical finding 1 and "Pallas fused-predict
    A/B": 1-pass and 3-pass bf16 both broke it).  PyTorch's matmul default is
    already fp32, but cuDNN's is TF32, so the port states both at its entry
    points.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
