"""Shared helpers of the SSM, hybrid and encoder-decoder parity tests
(``tests/test_torch_ssm.py``, ``tests/test_torch_encdec.py``): a function
and the gradients of sum(out * cot) in both packages on the same numpy
inputs, and the two criteria they are held to.

* float32: rtol 1e-4 and atol max(1e-6, F32_ATOL_REL x the largest
  magnitude of the reference's tensor). The SSD takes differences of
  float32 cumulative sums that reach hundreds (-A dt summed over a chunk),
  so its decays carry ~1e-5 relative error in either package; measured
  against the port's float64-stream run, both packages' float32 gradients
  of the reduced zamba2 lie 1.25e-5 of each leaf's largest gradient away
  (mamba2 3-5e-6, whisper 2-3e-6).
* bf16: each package rounds its (B, S, d_inner) tensors, ``L``, the
  attention probabilities and the products in bf16, in orders of its own
  (XLA picks the three-operand contractions' order), so the two bf16
  results differ by bf16 roundings, up to 10 % in norm on gradients that
  pass through four mamba layers and two attention blocks. The port's
  bf16 result is held to the reference's float32 result of the same
  inputs instead: its relative error in norm, ||port - f32|| / ||f32||,
  may exceed the reference's own bf16 error by at most 25 % and one bf16
  rounding (2^-9). Measured, the port's is the smaller on most tensors.

Not collected itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

F32_ATOL_REL = 2e-5
BF16_ROOM, BF16_FLOOR = 1.25, 2.0 ** -9


def pair(x, dtype, keep_f32=False):
    """numpy float32 -> (JAX array, torch leaf) in `dtype` (or float32)."""
    dt = "float32" if keep_f32 else dtype
    j = jnp.asarray(x).astype(jnp.dtype(dt))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dt)).requires_grad_()
    return j, t


def jax_vjp(fn, args, cot):
    """The reference's fn(*args) and the gradients of sum(out * cot), as
    float32 numpy."""
    def f(*a):
        out = fn(*a)
        return jnp.sum(out.astype(jnp.float32) * cot), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(len(args))), has_aux=True))(*args)
    return [np.asarray(jnp.asarray(v).astype(jnp.float32))
            for v in (out, *grads)]


def torch_vjp(fn, args, cot):
    out = fn(*args)
    grads = torch.autograd.grad(
        (out.float() * torch.from_numpy(cot)).sum(), list(args))
    return [v.detach().float().numpy() for v in (out, *grads)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


_F32 = {}


def _reference_f32(key, case):
    """The reference's float32 result of `case`, computed once per `key`
    (the float32 test and the bf16 test's yardstick share it)."""
    if key not in _F32:
        jfn, jargs, _, _, cot, _ = case("float32")
        _F32[key] = jax_vjp(jfn, jargs, cot)
    return _F32[key]


def compare(case, dtype, key):
    """`case(dtype)` -> (reference fn, its args, port fn, its args, cot,
    the args' names): the output and every gradient held as the module
    doc says. `key` names the case (for its cached float32 reference)."""
    jfn, jargs, tfn, targs, cot, names = case(dtype)
    want = (_reference_f32(key, case) if dtype == "float32"
            else jax_vjp(jfn, jargs, cot))
    got = torch_vjp(tfn, targs, cot)
    labels = ["out"] + [f"d {n}" for n in names]
    if dtype == "float32":
        for label, g, w in zip(labels, got, want):
            assert g.shape == w.shape, label
            atol = max(1e-6, F32_ATOL_REL * float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol,
                                       err_msg=label)
        return
    truth = _reference_f32(key, case)
    for label, g, w, t in zip(labels, got, want, truth):
        assert g.shape == w.shape and np.isfinite(g).all(), label
        port, ref = _rel(g, t), _rel(w, t)
        assert port <= BF16_ROOM * ref + BF16_FLOOR, (label, port, ref)
