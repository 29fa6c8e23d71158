"""float32 and bf16 subnormals, read and written as the JAX package does.

XLA (on the CPU, as here; a TPU has no subnormals) reads a float32 or bf16
subnormal operand of arithmetic or of a comparison as a zero of its own
sign and flushes a subnormal result of arithmetic to a zero of its sign;
conversions keep the bits. So ``jnp.sign(-1e-39)`` is 0, ``-1e-39 >= 0``
is True, and ``0.9 * -1e-38 + 0.1 * 0`` is +0.0. The port's sign helpers,
the plain versions of its kernels (which the kernels, built with
``-ftz=true``, are held to on the card) and its vote API must give the
same bits on the same inputs: numpy draws from a seed with the values
below planted among them. The reference runs through
``repro.kernels.ops`` in interpret mode and ``repro.core.sign_compress``.

One difference is the reference's and not about subnormals: XLA contracts
the float32 ``beta * m + (1 - beta) * g`` into an FMA, the port never
does, so where ``beta * m`` alone underflows (a normal m = -2^-126, g = 0)
the reference's zero keeps the product's sign (-0.0) and the port's is
+0.0; equal as values and in their sign bit words (+1).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro.configs.base import VoteStrategy as JS  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import sign_compress as jsc  # noqa: E402
from repro.core import vote_api as jva  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs.base import VoteStrategy as TS  # noqa: E402
from repro_torch.core import sign_compress as tsc  # noqa: E402
from repro_torch.core import vote_api as tva  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

#: the planted values: float32 subnormals (the largest below 2^-126 and the
#: smallest), their negatives, and zeros of both signs
SUBNORMALS = np.array([1e-39, -1e-39, 1.4e-45, -1.4e-45, 1e-38, -1e-38,
                       0.0, -0.0], np.float32)
#: momentum rows that decay into the subnormal range with g = 0
MOMENTA = np.array([1e-38, -1e-38, 1e-39, -1e-39, 1.4e-45, -1.4e-45],
                   np.float32)
N = 4133            # 129 words and a ragged 5
#: exponents of the power-of-two random g and m: beta * m and (1 - beta) *
#: g are then exact, so the reference's FMA and the port's two roundings
#: agree
EXP = (-30, 4)


def _rng(*salt):
    """A numpy generator seeded from `salt` (strings by their crc32)."""
    return np.random.default_rng(
        [29, *(zlib.crc32(s.encode()) if isinstance(s, str) else s
              for s in salt)])


def _planted(n, *salt, dtype="float32"):
    """n normals of `dtype` with the subnormals planted every 3rd place
    (and, for bf16, bf16 subnormals: float32 1e-39 cast to bf16 stays a
    subnormal)."""
    x = _rng(*salt).normal(size=n).astype(np.float32)
    x[::3] = np.resize(SUBNORMALS, x[::3].shape)
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32)).copy()).to(
        getattr(torch, dtype))
    return j, t


def _bits(t):
    """A tensor's bit patterns as unsigned numpy."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_sign_helpers_match_reference(dtype):
    """sign_ternary: a float32 / bf16 subnormal abstains; sign_binary: it
    goes to +1 whatever its sign. A float16 subnormal (a normal float32 to
    XLA) keeps its sign in both packages."""
    j, t = _planted(N, 1, dtype=dtype)
    if dtype == "float16":
        j = j.at[1::3].set(jnp.float16(-1e-7))
        t[1::3] = -1e-7
    for name in ("sign_ternary", "sign_binary"):
        got = getattr(tsc, name)(t)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jsc, name)(j)))
    if dtype != "float16":
        assert (tsc.sign_ternary(t)[::3] == 0).all()
        assert (tsc.sign_binary(t)[::3] == 1).all()
    out = torch.full((N,), 7, dtype=torch.int8)
    tsc.sign_ternary(t, out=out)
    assert torch.equal(out, tsc.sign_ternary(t))


def test_flush_helper():
    x = torch.from_numpy(SUBNORMALS.copy())
    f = tsc.flush_subnormals(x)
    assert _bits(f).tolist() == [0, 1 << 31, 0, 1 << 31, 0, 1 << 31, 0,
                                 1 << 31]
    assert torch.equal(tsc.flush_subnormals(torch.tensor([1.0, -2.5])),
                       torch.tensor([1.0, -2.5]))
    h = torch.tensor([-1e-7], dtype=torch.float16)
    assert _bits(tsc.flush_subnormals(h).float()) == _bits(h.float())
    tsc.flush_subnormals(x, out=x)
    assert torch.equal(x.view(torch.int32), f.view(torch.int32))


@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_momentum_sign_pack_matches_reference(gdtype, mdtype):
    """Kernel 1's plain version: m' as bit patterns and its words. g and m
    random powers of two (both products exact, so the reference's FMA
    rounds as the port does), g with planted subnormals, m with the
    planted momenta and g = 0 beside them."""
    rng = _rng(2, gdtype, mdtype)
    m, g = ((rng.choice([-1.0, 1.0], N)
             * np.exp2(rng.integers(*EXP, N))).astype(np.float32)
            for _ in range(2))
    g[::3] = np.resize(SUBNORMALS, g[::3].shape)
    m[1::4] = np.resize(MOMENTA, m[1::4].shape)
    g[1::4] = 0.0
    jg = jnp.asarray(g).astype(gdtype)
    tg = torch.from_numpy(np.asarray(jg.astype(jnp.float32)).copy()).to(
        getattr(torch, gdtype))
    jm = jnp.asarray(m).astype(mdtype)
    tm = torch.from_numpy(np.asarray(jm.astype(jnp.float32)).copy()).to(
        getattr(torch, mdtype))
    jm_new, jpacked = jops.momentum_sign_pack(jg, jm, 0.9)
    tm_new, tpacked = tops.momentum_sign_pack(tg, tm, 0.9)
    np.testing.assert_array_equal(_bits(tm_new), _jbits(jm_new))
    np.testing.assert_array_equal(tpacked.numpy().view(np.uint32),
                                  np.asarray(jpacked))
    # the planted momenta: beta * m flushed, then + 0.0 -> +0.0, bit +1
    assert (_bits(tm_new)[1::4] == 0).all()


def test_momentum_underflowing_product_of_a_normal_m():
    """m = -2^-126 (normal), g = 0: beta * m underflows. The words agree;
    m' is +0.0 in the port and -0.0 in the reference's FMA (see the module
    doc), equal as values."""
    m = np.full(64, -2.0 ** -126, np.float32)
    m[1::2] = 2.0 ** -126
    g = np.zeros(64, np.float32)
    jm_new, jp = jops.momentum_sign_pack(jnp.asarray(g), jnp.asarray(m), 0.9)
    tm_new, tp = tops.momentum_sign_pack(torch.from_numpy(g),
                                         torch.from_numpy(m), 0.9)
    np.testing.assert_array_equal(tp.numpy().view(np.uint32),
                                  np.asarray(jp))
    np.testing.assert_array_equal(tm_new.numpy(), np.asarray(jm_new))
    assert (_bits(tm_new) == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eta,wd", [(0.0, 0.0), (1e-38, 0.0), (1e-38, 0.1)])
def test_apply_vote_matches_reference(dtype, eta, wd):
    """Kernel 3's plain version on parameters with planted subnormals: with
    eta = 0 the result p - 0 of a subnormal p is flushed, and an eta of
    1e-38 is itself a subnormal operand, so every parameter keeps its
    value but the subnormals. (With a normal eta XLA contracts ``v + wd*p``
    into an FMA, as in the module doc; here each product is exact or
    flushed, so both roundings agree.)"""
    jp, tp = _planted(N, 4, dtype=dtype)
    words = _rng(5).integers(0, 2 ** 32, -(-N // 32), dtype=np.uint32)
    got = tops.apply_vote(tp, torch.from_numpy(words.view(np.int32)), eta,
                          wd)
    want = jops.apply_vote(jp, jnp.asarray(words), eta, wd)
    np.testing.assert_array_equal(_bits(got), _jbits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 4, 7])
def test_fused_majority_matches_reference(dtype, m):
    """Kernel 4's plain version: a subnormal voter votes +1."""
    x = np.stack([np.asarray(_planted(N, 6, r, dtype=dtype)[0]
                             .astype(jnp.float32)) for r in range(m)])
    x[:, 1::3] = -1e-39
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(
        tops.fused_majority(tx).numpy().view(np.uint32),
        np.asarray(jops.fused_majority(jx)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 4])
def test_bitpack_and_ternary_pack_match_reference(dtype, rows):
    """Kernels 6 and 7's plain versions: a subnormal packs as +1 on the
    1-bit wire and abstains (0b00) on the 2-bit one."""
    x = np.stack([np.asarray(_planted(N, 7, r, dtype=dtype)[0]
                             .astype(jnp.float32)) for r in range(rows)])
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # the reference's wrappers pack one flat row at a time
    np.testing.assert_array_equal(
        tops.bitpack(tx).numpy().view(np.uint32),
        np.stack([np.asarray(jops.bitpack(jx[r])) for r in range(rows)]))
    # the reference's ternary_pack takes the int8 symbols (its callers
    # extract them with sign_ternary); the port's also takes the values
    want = np.stack([np.asarray(jops.ternary_pack(jsc.sign_ternary(jx[r])))
                     for r in range(rows)])
    for arg in (tx, tsc.sign_ternary(tx)):
        np.testing.assert_array_equal(
            tops.ternary_pack(arg).numpy().view(np.uint32), want)


WIRES = [("sign1bit", "psum_int8"), ("sign1bit", "allgather_1bit"),
         ("sign1bit", "hierarchical"), ("ef_sign", "allgather_1bit"),
         ("ternary2bit", "allgather_1bit"), ("ternary2bit", "psum_int8"),
         ("weighted_vote", "allgather_1bit")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec,strategy", WIRES)
def test_vote_api_matches_reference(codec, strategy, dtype):
    """VirtualBackend.execute on the three wires and the four codecs: a
    stacked payload whose columns carry subnormals (a column of subnormals
    alone abstains on the count and 2-bit wires and ties to +1 on the
    1-bit wire); votes and server state bit-equal."""
    m = 5
    x = np.stack([np.asarray(_planted(N, 8, r, dtype=dtype)[0]
                             .astype(jnp.float32)) for r in range(m)])
    x[:, 2::5] = np.resize(SUBNORMALS, (m, x[:, 2::5].shape[1]))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    state = jcodecs.get_codec(codec).init_server_state(m)
    jout = jva.VirtualBackend().execute(jva.VoteRequest(
        payload=jx, form="stacked", strategy=JS(strategy), codec=codec,
        server_state=state or None))
    tout = tva.VirtualBackend(device="cpu").execute(tva.VoteRequest(
        payload=tx, form="stacked", strategy=TS(strategy), codec=codec,
        server_state={k: torch.from_numpy(np.array(v))
                      for k, v in state.items()} or None))
    np.testing.assert_array_equal(tout.votes.numpy(), np.asarray(jout.votes))
    np.testing.assert_array_equal(tout.wire_signs.numpy(),
                                  np.asarray(jout.wire_signs))
    for k in jout.server_state:
        np.testing.assert_array_equal(
            tout.server_state[k].numpy().view(np.uint32),
            np.asarray(jout.server_state[k]).view(np.uint32))
