"""Port parity for attention: ``ops/attention``, ``ops/flash_attention``
(the three kernels' plain versions and the differentiable entry point),
``parallel/ring`` and ``parallel/ulysses`` against the JAX package on the
same seeded numpy inputs.

The JAX side runs as its own tests run it: the Pallas kernels in
interpret mode, ring and Ulysses on a 4-device ``sp`` mesh of the virtual
CPU devices, the device-sink consumers on the JAX manager over 8 devices.
The port runs on the CPU, where every kernel wrapper takes its plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sparkucx_tpu.ops import attention as jatt
from sparkucx_tpu.ops.pallas import flash_attention as jfa
from sparkucx_tpu.parallel import ring as jring
from sparkucx_tpu.parallel import ulysses as july
from sparkucx_tpu_torch import backend, connect
from sparkucx_tpu_torch.ops import attention as tatt
from sparkucx_tpu_torch.ops import flash_attention as tfa
from sparkucx_tpu_torch.parallel import ring as tring
from sparkucx_tpu_torch.parallel import ulysses as tuly
from torch_attention_cases import qkv_rows

B, H, T, D = 2, 8, 64, 16


def _np(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(n))


def _both(xs):
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]


@pytest.fixture(scope="module")
def sp_mesh():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs >=4 devices")
    return Mesh(np.array(devs[:4]), ("sp",))


# -- ops/attention -----------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
def test_reference_and_blockwise_match_jax(causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_np((B, H, T, D), 1))
    jref = np.asarray(jatt.reference_attention(jq, jk, jv, causal=causal))
    tref = tatt.reference_attention(tq, tk, tv, causal=causal).numpy()
    np.testing.assert_allclose(tref, jref, atol=1e-5, rtol=1e-5)
    jb = np.asarray(jatt.blockwise_attention(jq, jk, jv, block_k=16,
                                             causal=causal))
    tb = tatt.blockwise_attention(tq, tk, tv, block_k=16,
                                  causal=causal).numpy()
    np.testing.assert_allclose(tb, jb, atol=1e-5, rtol=1e-5)


def test_blockwise_q_offset_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _both(_np((B, H, T, D), 2))
    jb = np.asarray(jatt.blockwise_attention(jq[:, :, 16:32], jk, jv,
                                             block_k=16, causal=True,
                                             q_offset=16))
    tb = tatt.blockwise_attention(tq[:, :, 16:32], tk, tv, block_k=16,
                                  causal=True, q_offset=16).numpy()
    np.testing.assert_allclose(tb, jb, atol=1e-5, rtol=1e-5)
    full = tatt.reference_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(tb, full[:, :, 16:32].numpy(), atol=1e-5,
                               rtol=1e-5)


def test_blockwise_rejects_indivisible_block_and_bias_matches_jax():
    q = torch.zeros((1, 1, 48, 8))
    with pytest.raises(ValueError, match="not divisible"):
        tatt.blockwise_attention(q, q, q, block_k=32)
    assert tatt.make_block_bias(4, 6, 8, 4, False) is None
    for qo, ko in ((0, 0), (8, 4), (3, 9)):
        np.testing.assert_array_equal(
            tatt.make_block_bias(5, 7, qo, ko, True).numpy(),
            np.asarray(jatt.make_block_bias(5, 7, qo, ko, True)))


# -- flash attention: forward and grads against JAX's interpret mode -------
FLASH_CASES = [  # (shape, block_q, block_k), as tests/test_pallas.py
    ((2, 4, 128, 32), 32, 32), ((2, 4, 128, 32), 48, 80),
    ((2, 4, 128, 32), 64, 32), ((1, 2, 33, 16), 32, 64),
    ((1, 2, 70, 16), 32, 32), ((1, 2, 97, 16), 32, 64),
    ((1, 2, 130, 16), 32, 64)]


def _case_id(c):
    return f"{'x'.join(map(str, c[0]))}-{c[1]}-{c[2]}"


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", FLASH_CASES, ids=_case_id)
def test_flash_forward_and_lse_match_jax(case, causal):
    shape, bq, bk = case
    (jq, jk, jv), (tq, tk, tv) = _both(_np(shape, sum(shape) + bq))
    jo = np.asarray(jfa.flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                                        causal=causal, impl="interpret"))
    to = tfa.flash_attention(tq, tk, tv, block_q=bq, block_k=bk,
                             causal=causal, impl="interpret")
    assert to.shape == tq.shape and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), jo, atol=2e-5, rtol=2e-5)
    # "pallas" on a CPU tensor runs the plain versions too
    tp = tfa.flash_attention(tq, tk, tv, block_q=bq, block_k=bk,
                             causal=causal, impl="pallas")
    np.testing.assert_allclose(tp.numpy(), jo, atol=2e-5, rtol=2e-5)
    b, h, t, d = shape
    scale = d ** -0.5
    _, jlse, _ = jfa._flash_call(jq, jk, jv, bq, bk, causal, scale, True)
    _, tlse = tfa.flash_fwd_plain(*(x.reshape(b * h, t, d)
                                    for x in (tq, tk, tv)), causal, scale)
    want = np.asarray(jlse)[:, 0, :t]
    assert (np.abs(tlse.numpy() - want) <= 1e-5 * (1 + np.abs(want))).all()


@pytest.mark.parametrize("loss", ["square", "sum"])
@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[2],
                                  FLASH_CASES[4]], ids=_case_id)
def test_flash_grads_match_jax(case, loss):
    shape, bq, bk = case
    (jq, jk, jv), (tq, tk, tv) = _both(_np(shape, 40 + bq))
    f = (lambda o: o ** 2) if loss == "square" else (lambda o: o)

    def jloss(q, k, v):
        return jnp.sum(f(jfa.flash_attention(q, k, v, block_q=bq, block_k=bk,
                                             causal=True, impl="interpret")))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tfa.flash_attention(*leaves, block_q=bq, block_k=bk, causal=True,
                              impl="interpret")
    tg = torch.autograd.grad(f(out).sum(), leaves)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_flash_noncausal_grads_match_jax():
    shape = (1, 3, 97, 8)
    (jq, jk, jv), (tq, tk, tv) = _both(_np(shape, 77))
    (jc,), (tc,) = _both(_np(shape, 78, n=1))

    def jloss(q, k, v):
        return jnp.sum(jc * jfa.flash_attention(q, k, v, block_q=32,
                                                block_k=64, impl="interpret"))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    for impl in ("interpret", "pallas", "scan"):
        out = tfa.flash_attention(*leaves, block_q=32, block_k=97, impl=impl)
        tg = torch.autograd.grad((tc * out).sum(), leaves)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                       rtol=1e-4, err_msg=impl)


# -- each kernel's plain version against its Pallas kernel in interpret mode
KERNEL_CASES = [(2, 33, 8), (3, 97, 16), (2, 130, 32), (1, 256, 32),
                (2, 64, 128)]          # (BH, T, D)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: "bh{}-t{}-d{}".format(*c))
def test_plain_kernels_match_pallas_interpret(case, causal):
    """flash_fwd_plain vs _fwd_pallas, flash_dq_plain and flash_dkv_plain
    vs _bwd_pallas, on JAX's padded inputs (the port bounds-checks instead
    of padding: compared on the first T rows)."""
    bh, t, d = case
    q, k, v, g = _np((bh, t, d), bh * 100 + t + d, n=4)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(x)[None] for x in (q, k, v))
    jo, jlse, (qf, kf, vf, bq, bk, tp) = jfa._flash_call(
        jq, jk, jv, 64, 64, causal, scale, True)
    gf = jfa._pad_t(jnp.asarray(g), tp)
    delta = jnp.sum(gf * jo, axis=-1)[:, None, :]
    jdq, jdk, jdv = jfa._bwd_pallas(qf, kf, vf, gf, jlse, delta, bq, bk,
                                    causal, scale, True, t)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    to, tlse = tfa.flash_fwd_plain(tq, tk, tv, causal, scale, 64, 64)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo)[:, :t], atol=2e-5,
                               rtol=2e-5)
    want_lse = np.asarray(jlse)[:, 0, :t]
    assert (np.abs(tlse.numpy() - want_lse)
            <= 1e-5 * (1 + np.abs(want_lse))).all()
    # the backward kernels take the same lse and delta on both sides
    lse_in = torch.from_numpy(np.array(want_lse))
    delta_in = torch.from_numpy(np.array(np.asarray(delta)[:, 0, :t]))
    tdq = tfa.flash_dq_plain(tq, tk, tv, tg, lse_in, delta_in, causal, scale,
                             64, 64)
    tdk, tdv = tfa.flash_dkv_plain(tq, tk, tv, tg, lse_in, delta_in, causal,
                                   scale, 64, 64)
    for a, b in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :t],
                                   atol=1e-4, rtol=1e-4)
    # the dispatchers take the plain versions for CPU tensors, and count
    # no launch
    before = backend.launch_counts()
    assert torch.equal(tfa.flash_fwd(tq, tk, tv, causal, scale)[1],
                       tfa.flash_fwd_plain(tq, tk, tv, causal, scale)[1])
    tfa.flash_dq(tq, tk, tv, tg, lse_in, delta_in, causal, scale)
    tfa.flash_dkv(tq, tk, tv, tg, lse_in, delta_in, causal, scale)
    assert backend.launch_counts() == before


def test_flash_attention_impls_and_dtypes():
    (tq, tk, tv) = (torch.from_numpy(x) for x in _np((1, 2, 40, 8), 5))
    with pytest.raises(ValueError, match="unknown flash_attention impl"):
        tfa.flash_attention(tq, tk, tv, impl="mosaic")
    ref = tatt.reference_attention(tq, tk, tv, causal=True)
    auto = tfa.flash_attention(tq, tk, tv, block_k=40, causal=True)
    np.testing.assert_allclose(auto.numpy(), ref.numpy(), atol=2e-5)
    # non-float32 inputs: computed in float32, returned in their dtype
    half = [x.to(torch.bfloat16).requires_grad_() for x in (tq, tk, tv)]
    out = tfa.flash_attention(*half, causal=True, impl="interpret")
    assert out.dtype == torch.bfloat16
    want = tatt.reference_attention(*(x.float() for x in half), causal=True)
    np.testing.assert_allclose(out.float().detach().numpy(), want.detach()
                               .numpy(), atol=2e-2)
    grads = torch.autograd.grad(out.float().sum(), half)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_kernel(tq[0], tk[0], tv[0], True, 0.3)
    with pytest.raises(ValueError, match="exceeds"):
        tfa._kernel_dim(160)


# -- ring and Ulysses, global view, against JAX on the sp mesh --------------
@pytest.mark.parametrize("which", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_global_view_matches_jax(sp_mesh, which, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_np((B, H, T, D), 11))
    if which == "ring":
        jo = jring.ring_attention(jq, jk, jv, sp_mesh, causal=causal)
        to = tring.ring_attention(tq, tk, tv, 4, causal=causal)
    else:
        jo = july.ulysses_attention(jq, jk, jv, sp_mesh, causal=causal,
                                    block_k=16)
        to = tuly.ulysses_attention(tq, tk, tv, 4, causal=causal,
                                    block_k=16)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "interpret", "pallas"])
def test_ulysses_under_each_impl_matches_reference(impl):
    (tq, tk, tv) = (torch.from_numpy(x) for x in _np((B, H, T, D), 12))
    ref = tatt.reference_attention(tq, tk, tv, causal=True)
    out = tuly.ulysses_attention(tq, tk, tv, 4, causal=True, block_k=16,
                                 impl=impl)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)


def test_not_divisible_rejected():
    q = torch.zeros((B, 6, T, D))
    with pytest.raises(ValueError, match="not divisible"):
        tuly.ulysses_attention(q, q, q, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tuly.ulysses_attention_consumer(4, 16, 6, D)
    with pytest.raises(ValueError, match="not divisible"):
        tring.ring_attention(q[:, :, :62], q[:, :, :62], q[:, :, :62], 4)


@pytest.mark.parametrize("which", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_global_view_grads_match_reference(which, causal):
    """Gradients through the port's ring (torch ops) and Ulysses (the
    flash backward's plain versions) against reference_attention's."""
    xs = [torch.from_numpy(x) for x in _np((B, H, T, D), 21)]
    (cot,) = (torch.from_numpy(x) for x in _np((B, H, T, D), 22, n=1))
    leaves = [x.clone().requires_grad_() for x in xs]
    if which == "ring":
        out = tring.ring_attention(*leaves, 4, causal=causal)
    else:
        out = tuly.ulysses_attention(*leaves, 4, causal=causal,
                                     impl="pallas")
    got = torch.autograd.grad((cot * out).sum(), leaves)
    ref_leaves = [x.clone().requires_grad_() for x in xs]
    want = torch.autograd.grad(
        (cot * tatt.reference_attention(*ref_leaves, causal=causal)).sum(),
        ref_leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4)


# -- the device-sink consumers on one shuffle read ---------------------------
N_SHARDS, CH, CD, CT, CMAPS = 8, 8, 8, 16, 4


def _stage(mgr, sid, qkv, pos):
    bounds = tuple(CT * (i + 1) for i in range(N_SHARDS - 1))
    h = mgr.register_shuffle(sid, CMAPS, N_SHARDS, partitioner="range",
                             bounds=bounds)
    per = qkv.shape[0] // CMAPS
    for mid in range(CMAPS):
        sel = pos[mid * per:(mid + 1) * per]
        w = mgr.get_writer(h, mid)
        w.write(sel.astype(np.int64), qkv[sel].reshape(len(sel), -1))
        w.commit(N_SHARDS)
    return h


@pytest.mark.parametrize("which", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_consumers_match_jax_on_device_sink_read(manager_factory, which,
                                                 causal):
    qkv, pos = qkv_rows(60 + causal, CH, CD, N_SHARDS * CT)
    jm = manager_factory({})
    jh = _stage(jm, 960, qkv, pos)
    if which == "ring":
        jstep = jring.ring_attention_consumer(jm.exchange_mesh, jm.axis, CT,
                                              CH, CD, causal=causal)
        tstep = tring.ring_attention_consumer(N_SHARDS, CT, CH, CD,
                                              causal=causal)
    else:
        jstep = july.ulysses_attention_consumer(jm.exchange_mesh, jm.axis,
                                                CT, CH, CD, causal=causal)
        tstep = tuly.ulysses_attention_consumer(N_SHARDS, CT, CH, CD,
                                                causal=causal)
    jout = np.asarray(jm.read(jh, sink="device").consume(
        lambda c, rows, nv: jstep(rows, nv)))
    with connect({"spark.shuffle.tpu.a2a.impl": "dense"}, device="cpu",
                 num_shards=N_SHARDS, use_env=False) as svc:
        th = _stage(svc.manager, 960, qkv, pos)
        res = svc.read(th, sink="device")
        tout = res.consume(lambda c, rows, totals: tstep(rows, totals))
        assert svc.report(960).d2h_bytes == 0
    assert tuple(tout.shape) == (1, CH, N_SHARDS * CT, CD)
    np.testing.assert_allclose(tout.numpy(), jout, atol=5e-5)
    q = torch.from_numpy(qkv[:, 0].transpose(1, 0, 2)[None].copy())
    k = torch.from_numpy(qkv[:, 1].transpose(1, 0, 2)[None].copy())
    v = torch.from_numpy(qkv[:, 2].transpose(1, 0, 2)[None].copy())
    ref = tatt.reference_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(tout.numpy(), ref.numpy(), atol=5e-5)


def test_decode_qkv_rows_matches_jax():
    """One shard and the batched form decode what JAX decodes, valid rows
    in any order and garbage past nvalid."""
    heads, hd, t, cap = 2, 4, 5, 9
    rng = np.random.default_rng(70)
    rows = rng.integers(-(1 << 20), 1 << 20, (3, cap, 2 + 3 * heads * hd)) \
        .astype(np.int32)
    nvalid = np.array([5, 5, 5], np.int32)
    for s in range(3):
        rows[s, :t, 0] = rng.permutation(t) + 100 * s
        rows[s, :t, 2:] = rng.standard_normal((t, 3 * heads * hd)).astype(
            np.float32).view(np.int32)
    bq, bk, bv = tring.decode_qkv_rows(torch.from_numpy(rows),
                                       torch.from_numpy(nvalid), t, heads, hd)
    assert tuple(bq.shape) == (3, 1, heads, t, hd)
    for s in range(3):
        jq, jk, jv = jring.decode_qkv_rows(jnp.asarray(rows[s]),
                                           jnp.asarray(nvalid[s:s + 1]), t,
                                           heads, hd)
        oq, ok, ov = tring.decode_qkv_rows(torch.from_numpy(rows[s]),
                                           torch.from_numpy(nvalid[s:s + 1]),
                                           t, heads, hd)
        for a, b, c in ((oq, bq, jq), (ok, bk, jk), (ov, bv, jv)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
            np.testing.assert_array_equal(b[s].numpy(), np.asarray(c))


@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_consumers_on_ordered_segment_move_read(which):
    """The smoke's read shape: the segment move (``a2a.impl=pallas``, its
    plain version on the CPU) under ``read(ordered=True, sink="device")``
    hands the consumer key-sorted rows with a valid-row prefix."""
    qkv, pos = qkv_rows(80, CH, CD, N_SHARDS * CT)
    make = tring.ring_attention_consumer if which == "ring" \
        else tuly.ulysses_attention_consumer
    step = make(N_SHARDS, CT, CH, CD, causal=True)
    with connect({"spark.shuffle.tpu.a2a.impl": "pallas"}, device="cpu",
                 num_shards=N_SHARDS, use_env=False) as svc:
        h = _stage(svc.manager, 961, qkv, pos)
        res = svc.read(h, ordered=True, sink="device")
        out = res.consume(lambda c, rows, totals: step(rows, totals))
        rep = svc.report(961)
    assert rep.impl == "pallas" and rep.d2h_bytes == 0
    q, k, v = (torch.from_numpy(qkv[:, i].transpose(1, 0, 2)[None].copy())
               for i in range(3))
    ref = tatt.reference_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=5e-5)
