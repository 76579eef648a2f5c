"""The seeded coefficient source (lcpc_tpu_torch.core.coeffs.SeededCoeffSource)
and its generator (ops/threefry.py) on the CPU, against lcpc_tpu: the same
threefry bits as jax.random, the same coefficients as lcpc_tpu's
SeededCoeffSource, and a seeded streaming commit and proof with lcpc_tpu's
bytes.  Tolerance 0 everywhere: the values are bits."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lcpc_tpu_torch as P
from lcpc_tpu_torch.ops import threefry as tf
from lcpc_tpu_torch.ops.limbs import get_ops
from lcpc_tpu_torch.ops.spmv import pack_words

torch.set_num_threads(1)  # the xdist workers share the cores

SEEDS = (0, 7, (1 << 40) + 3)


def _tr(pkg, enc, root):
    tr = pkg.Transcript(b"lcpc port seeded")
    tr.append_message(b"polycommit", root)
    tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
    return tr


def test_threefry_equals_jax_random_bits():
    """jax.random.bits(fold_in(PRNGKey(s), c), (W7, chunk), uint8) for the
    seeds and a few chunks, the folded keys, and the raw threefry2x32."""
    assert jax.config.jax_threefry_partitionable, (
        "lcpc_tpu's seeded values assume jax_threefry_partitionable (JAX's default since "
        "0.5); this JAX has it off")
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        assert tuple(int(v) for v in np.asarray(key)) == tf.prng_key(seed)
        for c in (0, 3, 1000):
            k = jax.random.fold_in(key, c)
            assert tuple(int(v) for v in np.asarray(k)) == tf.fold_in(tf.prng_key(seed), c)
            want = np.asarray(jax.random.bits(k, (37, 16), jnp.uint8))
            got = tf.seeded_digits_plain(tf.prng_key(seed), c, 1, 16, 37, [0xFF] * 37)
            np.testing.assert_array_equal(got.numpy(), want)
    x0 = np.array([0, 1, 0xFFFFFFFF, 12345], dtype=np.uint32)
    x1 = np.array([0, 2, 0xFFFFFFFF, 0x80000000], dtype=np.uint32)
    from jax._src import prng as jprng  # threefry2x32 itself has no public name

    want = jprng.threefry_2x32(jnp.array([0x1234, 0xABCDEF01], jnp.uint32),
                               jnp.concatenate([jnp.asarray(x0), jnp.asarray(x1)]))
    g0, g1 = tf.threefry2x32_plain(0x1234, 0xABCDEF01, torch.from_numpy(x0.astype(np.int64)),
                                   torch.from_numpy(x1.astype(np.int64)))
    np.testing.assert_array_equal(np.concatenate([g0.numpy(), g1.numpy()]),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("field", ["FT63", "FT255"])
def test_materialize_equals_reference(field):
    """SeededCoeffSource(spec, n, seed).materialize() is lcpc_tpu's, bit for
    bit, for three seeds (one >= 2^32), with a length that ends mid-chunk."""
    import lcpc_tpu as J
    from lcpc_tpu.core.coeffs import SeededCoeffSource as JSeeded

    for seed in SEEDS:
        want = np.asarray(JSeeded(getattr(J, field), 1000, seed=seed, chunk=64).materialize())
        got = P.SeededCoeffSource(getattr(P, field), 1000, seed=seed, chunk=64,
                                  device="cpu").materialize()
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_blocks_partition_forms_and_tail():
    """Two row partitionings give equal blocks; the digit, limb and packed
    forms hold one value; past `length` every form is zero; the values are
    below p."""
    spec = P.FT255
    src = P.SeededCoeffSource(spec, 40 * 24 - 11, seed=9, chunk=100, device="cpu")
    full = src.materialize()  # (W, length)
    for npr in (24, 40):
        src.set_dims(-(-src.length // npr), npr)
        limbs = torch.cat([src.block(r0, min(r0 + 5, src.n_rows))
                           for r0 in range(0, src.n_rows, 5)], dim=1).reshape(spec.w16, -1)
        assert torch.equal(limbs[:, : src.length], full)
        assert not limbs[:, src.length :].any()
        packed = src.block_packed(0, src.n_rows)
        assert torch.equal(packed, pack_words(src.block(0, src.n_rows), 0))
        digits = src.block_digits(0, src.n_rows).reshape(src.w7, -1)
        assert torch.equal(tf.digits_to_words_plain(digits, spec.w16 // 2),
                           packed.reshape(spec.w16 // 2, -1))
    assert src.resident_bytes == 0
    ints = get_ops(spec).decode_host(full, from_mont=False)
    assert max(ints) < 1 << (spec.num_bits - 1) < spec.p


def test_generator_refusals():
    with pytest.raises(ValueError, match="form"):
        tf.seeded_digits(P.FT63, (0, 1), 0, 8, 8, 4, form="words", device="cpu")
    with pytest.raises(ValueError, match="length and chunk"):
        P.SeededCoeffSource(P.FT63, 0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.SeededCoeffSource(P.FT63, 100)


def test_seeded_streaming_equals_reference_and_cross_verifies():
    """A seeded commit_streaming root and prove_streaming proof bytes equal
    lcpc_tpu's at ft63 from the same seed, and each package verifies the
    other's proof with the evaluation of the materialized coefficients."""
    import lcpc_tpu as J
    from lcpc_tpu.core import streaming as jstreaming
    from lcpc_tpu.core import wire as jwire
    from lcpc_tpu.core.coeffs import SeededCoeffSource as JSeeded

    length, seed = 64 * 700 - 13, 2024
    jenc = J.LigeroEncoding.new_from_dims(J.FT63, 64, 128)
    enc = P.LigeroEncoding.new_from_dims(P.FT63, 64, 128, device="cpu")
    jcs = jstreaming.commit_streaming(JSeeded(J.FT63, length, seed=seed, chunk=1 << 12), jenc,
                                      row_block=128)
    src = P.SeededCoeffSource(P.FT63, length, seed=seed, chunk=1 << 12, device="cpu")
    cs = P.commit_streaming(src, enc, row_block=128)
    root = cs.get_root()
    assert root == jcs.get_root()
    coeffs = get_ops(P.FT63).decode_host(P.SeededCoeffSource(
        P.FT63, length, seed=seed, chunk=1 << 12, device="cpu").materialize())
    x = random.Random(5).randrange(P.FT63.p)
    outer, inner = P.univariate_tensors(P.FT63, x, cs.n_per_row, cs.n_rows)
    data = P.wire.serialize_proof(P.FT63, cs.prove(outer, _tr(P, enc, root)))
    jdata = jwire.serialize_proof(J.FT63, jcs.prove(outer, _tr(J, jenc, root)))
    assert data == jdata
    want = P.univariate_eval(P.FT63, coeffs, x)
    assert jwire.deserialize_proof(J.FT63, data).verify(
        root, outer, inner, jenc, _tr(J, jenc, root)) == want
    assert P.wire.deserialize_proof(P.FT63, jdata).verify(
        root, outer, inner, enc, _tr(P, enc, root)) == want
