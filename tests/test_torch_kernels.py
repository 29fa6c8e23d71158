"""Parity of the port's kernel wrappers (plain path, CPU) with the JAX
package's kernels, run as ``tests/test_kernels.py`` runs them: through
``repro.kernels.ops`` in interpret mode. Inputs come from numpy seeds;
packed words are compared as uint32."""
import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro.configs.base import get_config, reduced_config  # noqa: E402
from repro.core import sign_compress as jsc  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import reduced_config as t_reduced  # noqa: E402
from repro_torch.core import sign_compress as tsc  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMPipeline as TPipe  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SIZES = [1, 31, 32, 33, 4096, 32768, 32785, 100_000]
#: the sign-kernel sweep, at most tests/test_kernels.py's interpret sizes
SIGN_SIZES = [1, 31, 32, 33, 4096, 32785]
SIGN_DTYPES = ["float32", "bfloat16", "int8"]


def _rng(*salt):
    return np.random.default_rng([11, *salt])


def _words(t):
    """int32 bit patterns -> uint32 numpy."""
    return t.numpy().view(np.uint32)


def _bf16_exact(x):
    """float32 values that bf16 holds exactly (so both frameworks start
    from the same bf16 numbers)."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("beta", [0.9, 0.99])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_momentum_sign_pack_matches_jax(n, gdtype, beta):
    rng = _rng(n, round(beta * 100))
    g = rng.normal(size=n).astype(np.float32)
    m = rng.normal(size=n).astype(np.float32)
    m[::7] = 0.0      # exact zeros: m' = 0 where g is 0 too -> bit +1
    g[::7] = 0.0
    if gdtype == "bfloat16":
        g = _bf16_exact(g)
    jg = jnp.asarray(g).astype(gdtype)
    jm_new, jpacked = jops.momentum_sign_pack(jg, jnp.asarray(m), beta)
    tg = torch.from_numpy(g).to(getattr(torch, gdtype))
    tm_new, tpacked = tops.momentum_sign_pack(tg, torch.from_numpy(m), beta)
    assert tpacked.dtype == torch.int32 and tpacked.shape == (-(-n // 32),)
    np.testing.assert_array_equal(_words(tpacked), np.asarray(jpacked))
    # the reference's own tolerance (tests/test_kernels.py:63-65): XLA may
    # contract beta*m + (1-beta)*g into an FMA, the port never does
    np.testing.assert_allclose(tm_new.numpy(), np.asarray(jm_new),
                               rtol=1e-6, atol=1e-6)


#: beta of the bf16-momentum checks: the last one's float32 value lies
#: exactly half-way between two bf16 values (0.5 and 0.50390625), so it
#: rounds to even (0.5) and not as the double would
BF16_BETAS = [0.9, 0.99, 0.5 + 2 ** -9 + 2 ** -31]


@pytest.mark.parametrize("beta", BF16_BETAS)
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_momentum_sign_pack_bf16_momentum_matches_jax(n, gdtype, beta):
    """bf16 momentum (the glm4-9b preset's): m' and the words bit-equal to
    the Pallas kernel in interpret mode and to the reference trainer's jnp
    expression ``beta * m + (1 - beta) * g.astype(bf16)``, which rounds
    the constants and every operation to bf16. Planted +0.0 / -0.0 in g
    and m make m' = +0.0 and -0.0, both bit +1. Tolerance: none."""
    rng = _rng(n, gdtype == "float32", BF16_BETAS.index(beta))
    g = rng.normal(size=n).astype(np.float32)
    m = (rng.normal(size=n) * 0.3).astype(np.float32)
    g[::7], m[::7] = 0.0, 0.0
    g[3::7], m[3::7] = -0.0, -0.0
    g[5::11], m[5::11] = -0.0, 0.0
    m = _bf16_exact(m)
    if gdtype == "bfloat16":
        g = _bf16_exact(g)
    jg = jnp.asarray(g).astype(gdtype)
    jm = jnp.asarray(m).astype(jnp.bfloat16)
    jm_new, jpacked = jops.momentum_sign_pack(jg, jm, beta)
    expr = beta * jm + (1 - beta) * jg.astype(jnp.bfloat16)
    tg = torch.from_numpy(g).to(getattr(torch, gdtype))
    tm = torch.from_numpy(m).to(torch.bfloat16)
    tm_new, tpacked = tops.momentum_sign_pack(tg, tm, beta)
    assert tm_new.dtype == torch.bfloat16 and jm_new.dtype == jnp.bfloat16
    got = tm_new.view(torch.int16).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm_new).view(np.int16))
    np.testing.assert_array_equal(got, np.asarray(expr).view(np.int16))
    np.testing.assert_array_equal(_words(tpacked), np.asarray(jpacked))
    np.testing.assert_array_equal(
        _words(tpacked), np.asarray(jsc.pack_signs(jnp.pad(
            expr, (0, (-n) % 32)))))
    # in place, with and without the words: the same m'
    tm2 = torch.from_numpy(m).to(torch.bfloat16)
    same, words = tops.momentum_sign_pack(tg, tm2, beta, m_out=tm2,
                                          pack=False)
    assert words is None and same.data_ptr() == tm2.data_ptr()
    np.testing.assert_array_equal(tm2.view(torch.int16).numpy(), got)


def test_momentum_constants_round_as_jax():
    """The constants of ``beta * m + (1 - beta) * g``: float32 for float32
    momentum, then bf16 for bf16 momentum, 1 - beta folded in double; the
    half-way beta rounds to even in float32 first."""
    assert tref.momentum_constants(0.9, torch.bfloat16) == (0.8984375,
                                                           0.10009765625)
    assert tref.momentum_constants(0.9, torch.float32) == (
        float(np.float32(0.9)), float(np.float32(1.0 - 0.9)))
    assert tref.momentum_constants(BF16_BETAS[2], torch.bfloat16)[0] == 0.5
    one = jnp.ones((), jnp.bfloat16)
    for beta in BF16_BETAS:   # the weakly typed constants times a bf16 1
        assert tref.momentum_constants(beta, torch.bfloat16) == (
            float(beta * one), float((1 - beta) * one))


#: the tallies' wider sweep: voter counts across the plane counts of the
#: card's bit-sliced counter (M < 256) and its kernel for any M, at word
#: counts of each remainder mod 4 (all within one 512-word Pallas block)
TALLY_VOTERS = [4, 8, 15, 17, 31, 32, 63, 64, 65, 255, 256, 257]
TALLY_WORDS = [508, 509, 510, 511]
#: (M, w, offset): the stack a contiguous view `offset` words into a larger
#: buffer, its out a view one word into another
TALLY_VIEWS = [(4, 510, 1), (17, 511, 3), (257, 509, 1)]


def _tally_cases(voters, words):
    """A tally test's first sweep under its first ids (w-major, offset
    0), then the wider sweep and the views."""
    return ([pytest.param(m, w, 0, id=f"{w}-{m}")
             for w in words for m in voters]
            + [pytest.param(m, w, 0, id=f"M{m}-w{w}")
               for m in TALLY_VOTERS for w in TALLY_WORDS]
            + [pytest.param(m, w, off, id=f"M{m}-w{w}-offset{off}")
               for m, w, off in TALLY_VIEWS])


def _tally(fn, words, offset):
    """fn on the (m, w) uint32 words; with an offset, on a view that many
    words into a larger buffer, into an out one word into another (the
    words around it held unchanged)."""
    m, w = words.shape
    t = torch.from_numpy(words.view(np.int32))
    if not offset:
        return _words(fn(t))
    buf = torch.zeros(offset + m * w + 3, dtype=torch.int32)
    packed = buf[offset:offset + m * w].view(m, w)
    packed.copy_(t)
    whole = torch.full((w + 2,), 0x5A5A5A5A, dtype=torch.int32)
    got = fn(packed, out=whole[1:1 + w])
    assert got.data_ptr() == whole[1].data_ptr()
    assert whole[[0, -1]].tolist() == [0x5A5A5A5A] * 2
    return _words(got)


@pytest.mark.parametrize(
    "m,w,offset", _tally_cases([1, 2, 3, 7, 16, 33], [1, 511, 512, 700]))
def test_majority_matches_jax(m, w, offset):
    p = _rng(m, w).integers(0, 2 ** 32, size=(m, w), dtype=np.uint32)
    got = _tally(tops.majority, p, offset)
    np.testing.assert_array_equal(got, np.asarray(jops.majority(
        jnp.asarray(p))))
    np.testing.assert_array_equal(got, np.asarray(jref.majority(
        jnp.asarray(p))))


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eta,wd", [(1e-3, 0.0), (1e-2, 0.1)])
def test_apply_vote_matches_jax(eta, wd, pdtype):
    n = 50_016 + 5   # ragged: the last word is part padding
    rng = _rng(round(eta * 1e4), round(wd * 10))
    p = rng.normal(size=n).astype(np.float32)
    if pdtype == "bfloat16":
        p = _bf16_exact(p)
    votes = rng.integers(0, 2 ** 32, size=-(-n // 32), dtype=np.uint32)
    expect = jops.apply_vote(jnp.asarray(p).astype(pdtype),
                             jnp.asarray(votes), eta, wd)
    got = tops.apply_vote(torch.from_numpy(p).to(getattr(torch, pdtype)),
                          torch.from_numpy(votes.view(np.int32)), eta, wd)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(expect.astype(jnp.float32)),
                               rtol=1e-5, atol=1e-6)


def _signed_payload(shape, dtype, *salt):
    """numpy values with planted zeros and -0.0 (a tie to +1 on the 1-bit
    wire, an abstention on the count wires), and the same values as a
    JAX array and a torch tensor of `dtype`."""
    rng = _rng(*salt)
    if dtype == "int8":
        x = rng.integers(-3, 4, size=shape).astype(np.int8)
        x[..., ::7] = 0
        return x, jnp.asarray(x), torch.from_numpy(x)
    x = rng.normal(size=shape).astype(np.float32)
    x[..., ::7] = 0.0
    x[..., 3::7] = -0.0
    if dtype == "bfloat16":
        x = _bf16_exact(x)
    return (x, jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", SIGN_DTYPES)
@pytest.mark.parametrize("n", SIGN_SIZES)
def test_bitpack_matches_jax(n, dtype):
    """(rows, n) -> (rows, ceil(n/32)), each row padded on its own: equal
    to the reference's kernel (interpret mode) row by row and to its
    oracle on the zero-padded rows."""
    x, jx, tx = _signed_payload((2, n), dtype, n, 1)
    got = _words(tops.bitpack(tx))
    assert got.shape == (2, -(-n // 32))
    for r in range(2):
        np.testing.assert_array_equal(got[r], np.asarray(jops.bitpack(jx[r])))
    padded = jnp.pad(jx, ((0, 0), (0, (-n) % 32)))
    np.testing.assert_array_equal(got, np.asarray(jref.bitpack(padded)))


#: bitpack's strided views: windows of a (rows, width) buffer whose rows
#: are `width` elements apart (128 keeps every row on a 16-byte boundary in
#: every dtype, 133 drifts off it), starting at column 0, 32 (a VotePlan
#: bucket's ALIGN) and 1 (off 16 bytes); each test takes every length
#: 64 + r, r = 0..31 (each remainder mod 32)
STRIDE_WIDTHS = [128, 133]
STRIDE_STARTS = [0, 32, 1]


@pytest.mark.parametrize("dtype", SIGN_DTYPES)
@pytest.mark.parametrize("c0", STRIDE_STARTS)
@pytest.mark.parametrize("width", STRIDE_WIDTHS)
@pytest.mark.parametrize("rows", [1, 4, 7])
def test_bitpack_strided_view_matches_jax(rows, width, c0, dtype):
    """A window whose rows are `width` apart (stride(1) == 1, stride(0) >=
    n): equal to the reference's oracle on the zero-padded contiguous
    window, and to the port's bitpack of the window copied contiguous."""
    x, _, buf = _signed_payload((rows, width), dtype, rows, width, c0, 5)
    lengths = [64 + r for r in range(32)]
    # every window zero-padded to 96 columns and stacked: one oracle call
    stack = np.concatenate([np.pad(x[:, c0:c0 + n], ((0, 0), (0, 96 - n)))
                            for n in lengths])
    want = np.asarray(jref.bitpack(jnp.asarray(stack).astype(dtype)))
    want = want.reshape(len(lengths), rows, 3)
    for i, n in enumerate(lengths):
        view = buf[:, c0:c0 + n]
        assert view.stride() == (width, 1)
        got = tops.bitpack(view)
        np.testing.assert_array_equal(_words(got), want[i, :, :-(-n // 32)])
        assert torch.equal(got, tops.bitpack(view.contiguous()))


@pytest.mark.parametrize("dtype", SIGN_DTYPES)
@pytest.mark.parametrize("n", SIGN_SIZES)
def test_bitunpack_matches_jax(n, dtype):
    words = _rng(n, 2).integers(0, 2 ** 32, size=-(-n // 32) + 1,
                                dtype=np.uint32)   # one word to spare
    got = tops.bitunpack(torch.from_numpy(words.view(np.int32)), n,
                         getattr(torch, dtype))
    assert got.shape == (n,) and got.dtype == getattr(torch, dtype)
    got = got.to(torch.float32).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.bitunpack(jnp.asarray(words), n, dtype),
                        np.float32))
    np.testing.assert_array_equal(
        got, np.asarray(jref.bitunpack(jnp.asarray(words)[None], dtype),
                        np.float32)[0, :n])


@pytest.mark.parametrize("m", [1, 2, 3, 7, 16, 33])
@pytest.mark.parametrize("n", SIGN_SIZES)
def test_fused_majority_matches_jax(n, m):
    for dtype in SIGN_DTYPES:
        x, jx, tx = _signed_payload((m, n), dtype, n, m)
        got = _words(tops.fused_majority(tx))
        assert got.shape == (-(-n // 32),)
        np.testing.assert_array_equal(
            got, np.asarray(jops.fused_majority(jx)), err_msg=dtype)
        padded = jnp.pad(jx, ((0, 0), (0, (-n) % 32)))
        np.testing.assert_array_equal(
            got, np.asarray(jref.fused_majority(padded)), err_msg=dtype)


def test_fused_majority_equals_staged_kernels():
    """fused_majority == bitpack of every voter + majority, the staged
    path it replaces."""
    x = torch.from_numpy(_rng(9).normal(size=(9, 10_000)).astype(np.float32))
    assert torch.equal(tops.fused_majority(x),
                       tops.majority(tops.bitpack(x)))


@pytest.mark.parametrize("n", [32, 96, 1000])
def test_sign_compress_matches_jax(n):
    rng = _rng(n)
    x = rng.normal(size=(3, n)).astype(np.float32)
    x[:, ::5] = 0.0
    x[:, 1::5] = -0.0
    np.testing.assert_array_equal(
        tsc.sign_binary(torch.from_numpy(x)).numpy(),
        np.asarray(jsc.sign_binary(jnp.asarray(x))))
    flat, n0 = tsc.pad_to_pack(torch.from_numpy(x[0]))
    assert n0 == n and flat.shape[0] % 32 == 0
    np.testing.assert_array_equal(flat[:n].numpy(), x[0])
    xp = x[:, : n - n % 32]
    words = tsc.pack_signs(torch.from_numpy(xp))
    jwords = jsc.pack_signs(jnp.asarray(xp))
    np.testing.assert_array_equal(_words(words), np.asarray(jwords))
    np.testing.assert_array_equal(
        tsc.unpack_signs(words, torch.float32).numpy(),
        np.asarray(jsc.unpack_signs(jwords, jnp.float32)))
    np.testing.assert_array_equal(_words(tsc.packed_majority(words)),
                                  np.asarray(jsc.packed_majority(jwords)))
    np.testing.assert_array_equal(
        tsc.sign_ternary(torch.from_numpy(x)).numpy(),
        np.asarray(jsc.sign_ternary(jnp.asarray(x))))
    for multiple in (32, 96):
        got, n1 = tsc.pad_last(torch.from_numpy(x), multiple)
        want, n2 = jsc.pad_last(jnp.asarray(x), multiple)
        assert n1 == n2 == n
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_padding_bits_are_plus_one():
    """The last word's bits past n are 1 (sign(0) = +1), as zero padding
    makes them in the reference."""
    g = -torch.ones(33)
    _, packed = tops.momentum_sign_pack(g, torch.zeros(33), 0.9)
    assert _words(packed).tolist() == [0, 0xFFFFFFFE]


def test_plain_path_in_place_and_uncounted():
    tops.reset_launch_counts()
    rng = _rng(5)
    g = torch.from_numpy(rng.normal(size=100).astype(np.float32))
    m = torch.from_numpy(rng.normal(size=100).astype(np.float32))
    expect_m, expect_p = tref.momentum_sign_pack(
        tsc.pad_to_pack(g)[0], tsc.pad_to_pack(m)[0], 0.9)
    words = torch.empty((2, 4), dtype=torch.int32)
    m_new, packed = tops.momentum_sign_pack(g, m, 0.9, m_out=m,
                                            packed_out=words[1])
    assert m_new.data_ptr() == m.data_ptr()
    assert packed.data_ptr() == words[1].data_ptr()
    assert torch.equal(m, expect_m[:100]) and torch.equal(words[1], expect_p)
    p = torch.from_numpy(rng.normal(size=100).astype(np.float32))
    expect = tref.apply_vote(tsc.pad_to_pack(p)[0], packed, 1e-2, 0.1)[:100]
    out = tops.apply_vote(p, packed, 1e-2, 0.1, out=p)
    assert out.data_ptr() == p.data_ptr() and torch.equal(p, expect)
    assert tops.launch_counts() == {"momentum_sign_pack": 0, "majority": 0,
                                    "apply_vote": 0, "bitpack": 0,
                                    "bitunpack": 0, "fused_majority": 0,
                                    "ternary_pack": 0, "ternary_majority": 0,
                                    "ternary_majority_plus_one": 0,
                                    "ternary_unpack": 0,
                                    "apply_ternary_vote": 0,
                                    "adversary": 0, "adversary_map": 0}


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_momentum_without_pack_writes_the_same_momentum(gdtype):
    """``pack=False`` (the ternary2bit and ef_sign encode) writes m' bit
    for bit as the packing call does, returns no words and counts no
    launch on the CPU."""
    tops.reset_launch_counts()
    rng = _rng(11)
    g = torch.from_numpy(rng.normal(size=77).astype(np.float32)).to(gdtype)
    m = torch.from_numpy(rng.normal(size=77).astype(np.float32))
    want, _ = tops.momentum_sign_pack(g, m, 0.9)
    got, words = tops.momentum_sign_pack(g, m, 0.9, m_out=m, pack=False)
    assert words is None and got.data_ptr() == m.data_ptr()
    assert torch.equal(m, want)
    assert tops.launch_counts()["momentum_sign_pack"] == 0


@pytest.mark.parametrize("case", ["g_2d", "m_bf16", "len", "words_int64",
                                  "noncontig", "votes_len", "no_voters",
                                  "pack_1d", "pack_f64", "pack_noncontig",
                                  "unpack_too_many", "unpack_f64",
                                  "unpack_2d", "fused_no_voters",
                                  "fused_f16", "tpack_1d", "tpack_i32",
                                  "tpack_out_shape", "tmaj_no_voters",
                                  "tmaj_int64", "tunpack_too_many",
                                  "tunpack_int64", "tapply_votes_len",
                                  "pack_out_dtype", "msp_words_unwanted",
                                  "pack_col_stride", "pack_rows_overlap"])
def test_wrappers_reject_bad_inputs(case):
    g, m = torch.zeros(64), torch.zeros(64)
    with pytest.raises((ValueError, TypeError)):
        if case == "g_2d":
            tops.momentum_sign_pack(g.reshape(2, 32), m, 0.9)
        elif case == "m_bf16":   # m' must come out in m's dtype
            tops.momentum_sign_pack(g, m.to(torch.bfloat16), 0.9, m_out=m)
        elif case == "len":
            tops.momentum_sign_pack(g, torch.zeros(65), 0.9)
        elif case == "msp_words_unwanted":
            tops.momentum_sign_pack(g, m, 0.9, pack=False,
                                    packed_out=torch.zeros(2, dtype=torch.int32))
        elif case == "words_int64":
            tops.majority(torch.zeros((2, 3), dtype=torch.int64))
        elif case == "noncontig":
            tops.apply_vote(torch.zeros(128)[::2], torch.zeros(2, dtype=torch.int32),
                            1e-3, 0.0)
        elif case == "votes_len":
            tops.apply_vote(g, torch.zeros(3, dtype=torch.int32), 1e-3, 0.0)
        elif case == "pack_1d":
            tops.bitpack(g)
        elif case == "pack_f64":
            tops.bitpack(g.reshape(2, 32).double())
        elif case == "pack_noncontig":
            tops.bitpack(g.reshape(8, 8).t())
        elif case == "pack_col_stride":    # rows apart, columns not adjacent
            tops.bitpack(g.reshape(4, 16)[:, ::2])
        elif case == "pack_rows_overlap":  # stride(0) < n: rows overlap
            tops.bitpack(g.as_strided((2, 32), (16, 1)))
        elif case == "unpack_too_many":
            tops.bitunpack(torch.zeros(2, dtype=torch.int32), 65)
        elif case == "unpack_f64":
            tops.bitunpack(torch.zeros(2, dtype=torch.int32), 64,
                           torch.float64)
        elif case == "unpack_2d":
            tops.bitunpack(torch.zeros((1, 2), dtype=torch.int32), 64)
        elif case == "fused_no_voters":
            tops.fused_majority(torch.zeros((0, 3)))
        elif case == "fused_f16":
            tops.fused_majority(g.reshape(2, 32).half())
        elif case == "tpack_1d":
            tops.ternary_pack(g)
        elif case == "tpack_i32":
            tops.ternary_pack(g.reshape(2, 32).int())
        elif case == "tpack_out_shape":
            tops.ternary_pack(g.reshape(2, 32),
                              out=torch.zeros((2, 4), dtype=torch.int32))
        elif case == "tmaj_no_voters":
            tops.ternary_majority(torch.zeros((0, 3), dtype=torch.int32))
        elif case == "tmaj_int64":
            tops.ternary_majority(torch.zeros((2, 3), dtype=torch.int64))
        elif case == "tunpack_too_many":
            tops.ternary_unpack(torch.zeros(2, dtype=torch.int32), 33)
        elif case == "tunpack_int64":
            tops.ternary_unpack(torch.zeros(2, dtype=torch.int64), 32)
        elif case == "tapply_votes_len":
            # 64 elements take 4 two-bit words, not the 1-bit wire's 2
            tops.apply_ternary_vote(g, torch.zeros(2, dtype=torch.int32),
                                    1e-3, 0.0)
        elif case == "pack_out_dtype":
            tops.bitpack(g.reshape(2, 32),
                         out=torch.zeros((2, 1), dtype=torch.int64))
        else:
            tops.majority(torch.zeros((0, 3), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the ternary 2-bit wire (codec ternary2bit): kernels 7-8 and their helpers
# ---------------------------------------------------------------------------

#: tests/test_codecs.py:95's sweep plus ragged lengths around a word
TERNARY_CASES = [(1, 16), (4, 100), (9, 5000), (3, 1), (3, 15), (3, 17),
                 (3, 33)]


def _ternary_payload(m, n, dtype, *salt):
    """(m, n) payloads for ternary_pack. int8: any int8 value (only the low
    two bits are packed), with the {-1, 0, +1} symbols in the first half;
    float: normal values with planted +0.0 / -0.0 (both abstain)."""
    rng = _rng(m, n, *salt)
    if dtype == "int8":
        x = rng.integers(-128, 128, size=(m, n)).astype(np.int8)
        x[:, : n // 2] = rng.integers(-1, 2, size=(m, n // 2))
        x[:, ::7] = 0
        return x, torch.from_numpy(x)
    x = rng.normal(size=(m, n)).astype(np.float32)
    x[:, ::5] = 0.0
    x[:, 2::5] = -0.0
    if dtype == "bfloat16":
        x = _bf16_exact(x)
    return x, torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", SIGN_DTYPES)
@pytest.mark.parametrize("m,n", TERNARY_CASES)
def test_ternary_pack_matches_jax(m, n, dtype):
    """(m, n) -> (m, ceil(n/16)) words, each row padded with abstaining
    fields: equal to the reference's kernel (interpret mode) row by row
    and to its oracle on the zero-padded rows. The reference packs int
    symbols; a float row is handed to it as its sign_ternary, which is
    what the port's kernel packs from the values."""
    x, tx = _ternary_payload(m, n, dtype, 1)
    got = _words(tops.ternary_pack(tx))
    assert got.shape == (m, -(-n // 16))
    sym = x if dtype == "int8" else np.asarray(
        jsc.sign_ternary(jnp.asarray(x)))
    for r in range(m):
        np.testing.assert_array_equal(
            got[r], np.asarray(jops.ternary_pack(jnp.asarray(sym[r]))))
    padded = np.pad(sym, ((0, 0), (0, (-n) % 16)))
    np.testing.assert_array_equal(
        got, np.asarray(jref.ternary_pack(jnp.asarray(padded))))


def _planted_words(m, w, *salt):
    """(m, w) random words (every field pattern, 0b10 included) with the
    first voter column's fields set to plant ties: half the voters +1,
    half -1 in word 0."""
    words = _rng(m, w, *salt).integers(0, 2 ** 32, size=(m, w),
                                       dtype=np.uint32)
    half = m // 2
    words[:half, 0] = 0x55555555          # +1 in every field
    words[half:2 * half, 0] = 0xFFFFFFFF  # -1 in every field
    return words


@pytest.mark.parametrize("m,w,offset", _tally_cases([1, 2, 3, 4, 9, 16, 33],
                                                    [1, 7, 313, 517]))
def test_ternary_majority_matches_jax(m, w, offset):
    words = _planted_words(m, w)
    got = _tally(tops.ternary_majority, words, offset)
    np.testing.assert_array_equal(
        got, np.asarray(jops.ternary_majority(jnp.asarray(words))))
    np.testing.assert_array_equal(
        got, np.asarray(jref.ternary_majority(jnp.asarray(words))))
    if m % 2 == 0:   # the planted exact ties decode to 0
        assert got[0] == 0


def test_ternary_majority_reads_0b10_as_zero():
    """The unused pattern 0b10 counts 0, never -2: one +1 against two 0b10
    fields is +1."""
    words = np.array([[0x1], [0x2], [0x2]], np.uint32)
    got = _words(tops.ternary_majority(torch.from_numpy(words.view(np.int32))))
    assert got.tolist() == [0x1]
    assert np.asarray(jops.ternary_majority(jnp.asarray(words))).tolist() \
        == [0x1]


@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 100, 5000])
def test_ternary_unpack_matches_jax(n):
    words = _rng(n, 3).integers(0, 2 ** 32, size=-(-n // 16) + 1,
                                dtype=np.uint32)   # one word to spare
    got = tops.ternary_unpack(torch.from_numpy(words.view(np.int32)), n)
    assert got.shape == (n,) and got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.ternary_unpack(jnp.asarray(words), n)))


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eta,wd", [(1e-3, 0.0), (1e-2, 0.1)])
def test_apply_ternary_vote_matches_jax(eta, wd, pdtype):
    """Equal bits to the reference's update
    (``repro.core.signum`` ``apply``: p32 - eta*(v + wd*p32), cast back)
    with the vote decoded by ``repro.core.sign_compress.unpack_ternary``;
    with wd = 0 an abstaining coordinate keeps its value exactly."""
    n = 50_016 + 5   # ragged: the last word is part padding
    rng = _rng(round(eta * 1e4), round(wd * 10), 4)
    p = rng.normal(size=n).astype(np.float32)
    if pdtype == "bfloat16":
        p = _bf16_exact(p)
    votes = rng.integers(0, 2 ** 32, size=-(-n // 16), dtype=np.uint32)
    v = jsc.unpack_ternary(jnp.asarray(votes), jnp.float32)[:n]
    jp = jnp.asarray(p).astype(pdtype)
    p32 = jp.astype(jnp.float32)
    expect = np.asarray((p32 - eta * (v + wd * p32)).astype(pdtype)
                        .astype(jnp.float32))
    got = tops.apply_ternary_vote(
        torch.from_numpy(p).to(getattr(torch, pdtype)),
        torch.from_numpy(votes.view(np.int32)), eta, wd)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), expect)
    if wd == 0.0:
        held = np.asarray(v) == 0
        assert held.any()
        np.testing.assert_array_equal(got.to(torch.float32).numpy()[held],
                                      p[held])


def _jax_apply(kernel, p, votes, eta, wd, pdtype):
    """The JAX package's update of `p` (float32 numpy of `pdtype` values)
    by `votes` (uint32 numpy), as float32 numpy: ``repro.kernels.ops``
    ``apply_vote`` in interpret mode, or the reference's jnp apply
    (``repro.core.signum``) of the decoded ternary vote."""
    jp = jnp.asarray(p).astype(pdtype)
    if kernel == "apply_vote":
        new = jops.apply_vote(jp, jnp.asarray(votes), eta, wd)
    else:
        v = jsc.unpack_ternary(jnp.asarray(votes), jnp.float32)[:p.size]
        p32 = jp.astype(jnp.float32)
        new = (p32 - eta * (v + wd * p32)).astype(pdtype)
    return np.asarray(new.astype(jnp.float32))


@pytest.mark.parametrize("n", [1, 31, 33, 50_021])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["apply_vote", "apply_ternary_vote"])
def test_apply_on_views_matches_jax(kernel, pdtype, offset, n):
    """The wrapper contract of both applies on a contiguous view
    ``buf[offset:offset + n]``, on or off a 16-byte boundary (the card
    takes its 16-byte path or its element path): into a new tensor and in
    place, the JAX package's update, and the elements around the view
    untouched. The ternary votes carry planted ``0b10`` fields (read 0)."""
    ternary = kernel == "apply_ternary_vote"
    rng = _rng(n, offset, int(ternary), 14)
    eta, wd = 1e-2, 0.1
    buf = rng.normal(size=offset + n + 5).astype(np.float32)
    if pdtype == "bfloat16":
        buf = _bf16_exact(buf)
    votes = rng.integers(0, 2 ** 32, size=-(-n // (16 if ternary else 32)),
                         dtype=np.uint32)
    if ternary:
        votes[::5] = 0xAAAAAAAA
    expect = _jax_apply(kernel, buf[offset:offset + n], votes, eta, wd,
                        pdtype)
    tbuf = torch.from_numpy(buf).to(getattr(torch, pdtype))
    before = tbuf.clone()
    p = tbuf[offset:offset + n]
    tv = torch.from_numpy(votes.view(np.int32))
    fresh = getattr(tops, kernel)(p, tv, eta, wd)
    assert fresh.data_ptr() != p.data_ptr()
    assert getattr(tops, kernel)(p, tv, eta, wd, out=p).data_ptr() \
        == p.data_ptr()
    for got in (fresh, p):
        got = got.to(torch.float32).numpy()
        if pdtype == "float32" and not ternary:
            # test_apply_vote_matches_jax's tolerance: XLA may contract
            # the update into an FMA, the port never does
            np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, expect)
    assert torch.equal(tbuf[:offset], before[:offset])
    assert torch.equal(tbuf[offset + n:], before[offset + n:])


@pytest.mark.parametrize("m,n", [(1, 16), (4, 96), (9, 5008)])
def test_ternary_sign_compress_matches_jax(m, n):
    """pack_ternary / unpack_ternary / ternary_majority / popcount of the
    port's sign_compress against the reference's, words as uint32."""
    s = _rng(m, n, 5).integers(-1, 2, size=(m, n)).astype(np.int8)
    tw = tsc.pack_ternary(torch.from_numpy(s))
    jw = jsc.pack_ternary(jnp.asarray(s))
    np.testing.assert_array_equal(_words(tw), np.asarray(jw))
    np.testing.assert_array_equal(tsc.unpack_ternary(tw).numpy(), s)
    words = _planted_words(m, n // 16, 6)
    tws = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(
        tsc.unpack_ternary(tws, torch.int32).numpy(),
        np.asarray(jsc.unpack_ternary(jnp.asarray(words), jnp.int32)))
    np.testing.assert_array_equal(
        _words(tsc.ternary_majority(tws)),
        np.asarray(jsc.ternary_majority(jnp.asarray(words))))
    np.testing.assert_array_equal(
        tsc.popcount(tws).numpy(), np.asarray(jsc.popcount(jnp.asarray(words))))
    with pytest.raises(ValueError, match=r"\(9,\)"):
        tsc.pack_ternary(torch.zeros(9, dtype=torch.int8))


def test_ternary_padding_fields_abstain():
    """A row's fields past n are 0b00 (abstain), each row on its own —
    where the 1-bit wire pads with +1 bits."""
    x = -torch.ones((2, 17), dtype=torch.int8)
    got = _words(tops.ternary_pack(x))
    assert got.tolist() == [[0xFFFFFFFF, 0x3]] * 2
    assert _words(tops.bitpack(x)).tolist() == [[0xFFFE0000]] * 2
    assert tops.ternary_unpack(tops.ternary_pack(x)[0], 17).tolist() \
        == [-1] * 17


def test_ternary_plain_path_in_place_and_uncounted():
    tops.reset_launch_counts()
    x = torch.from_numpy(_rng(7).normal(size=(3, 40)).astype(np.float32))
    words = torch.empty((4, 3), dtype=torch.int32)
    out = tops.ternary_pack(x, out=words[1:])
    assert out.data_ptr() == words[1].data_ptr()
    maj = torch.empty(3, dtype=torch.int32)
    assert tops.ternary_majority(words[1:], out=maj).data_ptr() \
        == maj.data_ptr()
    np.testing.assert_array_equal(
        tops.ternary_unpack(maj, 40).numpy(),
        np.sign(np.sign(x.numpy()).sum(axis=0)).astype(np.int8))
    p = torch.zeros(40)
    assert tops.apply_ternary_vote(p, maj, 1e-2, 0.0, out=p).data_ptr() \
        == p.data_ptr()
    assert set(tops.launch_counts().values()) == {0}


@pytest.mark.parametrize("split", ["global", "replica"])
def test_pipeline_tokens_equal(split):
    cfg = reduced_config(get_config("glm4-9b"))
    tcfg = t_reduced(t_get_config("glm4-9b"))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    ref_pipe = SyntheticLMPipeline(cfg, 8, 64, seed=3)
    port_pipe = TPipe(tcfg, 8, 64, seed=3)
    for step in (0, 7):
        if split == "global":
            a = ref_pipe.global_batch_at(step)["tokens"]
            b = port_pipe.global_batch_at(step)["tokens"]
        else:
            a = ref_pipe.replica_batch(step, 2, 4)["tokens"]
            b = port_pipe.replica_batch(step, 2, 4)["tokens"]
        np.testing.assert_array_equal(a, b)


def test_edited_source_builds_to_a_new_library(tmp_path, monkeypatch):
    """Each source builds to a library file of its own whose name carries
    a digest of the source and the nvcc flags, so an edited source is
    rebuilt and the others are loaded as they are."""
    from repro_torch.kernels import build
    before = {name: build._target(name) for name in build.SIGNATURES}
    assert len(set(before.values())) == len(before)
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert {name: build._target(name) for name in build.SIGNATURES} == before
    with open(csrc / "signum_update.cu", "a") as f:
        f.write("// edited\n")
    after = {name: build._target(name) for name in build.SIGNATURES}
    assert after["signum_update"] != before["signum_update"]
    assert {k: v for k, v in after.items() if k != "signum_update"} \
        == {k: v for k, v in before.items() if k != "signum_update"}
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build._target("vote") != before["vote"]
