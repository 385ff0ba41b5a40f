"""The port's fused path in training — the plain versions of both
kernels under the autograd Function, on CPU tensors — against the JAX
package's Pallas path in interpret mode, both bf16: loss and per-leaf
gradients of a coarse + fine render with the shared net (relative
Frobenius < 5e-2, cosine > 0.995, the bars of
tests/test_reference_parity.py:417-455). Helpers live in
tests/test_torch_train_step.py."""

from test_torch_train_step import check_hierarchical


def test_grads_match_jax_hierarchical_bf16_kernel():
    """Coarse + fine with the shared net through the port's fused path
    (the plain versions of both kernels, on CPU tensors) against JAX's
    Pallas path in interpret mode, both bf16."""
    # Op by op: XLA's jit may keep excess precision through bf16 roundings.
    check_hierarchical(dict(compute_dtype="bfloat16", use_kernel=True),
                       loss_tol=1e-4, jit=False)
