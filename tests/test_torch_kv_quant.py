"""The port's int8/fp8 KV pages on the CPU at a tiny f32 size, against
the JAX package's quantized engine running the same script: the
quantizer itself bit for bit on the same values, the pool's codes after
the same admissions bit for bit, ``debug_logits`` within 1e-4 of the JAX
quantized engine and within ``LOGIT_TOLERANCE`` of the port's model-dtype
engine through mid-flight admission and a copy-on-write hit, and a hit's
seeded prefill attending over dequantized values."""

import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads import decode_loop as jdl
from kubeoperator_tpu_torch.workloads import decode_loop as tdl
from test_torch_decode_loop import (  # noqa: F401 (model, params: fixtures)
    MIXED, admit_tracked, drain, engine, jax_engine, model, params, solo,
)
from test_torch_prefix_cache import PRE, page_accounting_exact

torch.set_num_threads(2)

KINDS = ["int8", "fp8"]
# the JAX and port models compute K/V with their own f32 products, a few
# ulps apart; a scale is amax/qmax of those values, so it inherits that
# relative difference (the quantizer alone is exact: see the first test)
SCALE_RTOL = 2e-6


def test_constants_match_jax():
    assert tdl._QMAX == jdl._QMAX
    assert tdl.KV_DTYPES == jdl.KV_DTYPES
    assert tdl.LOGIT_TOLERANCE == jdl.LOGIT_TOLERANCE


@pytest.mark.parametrize("kv", KINDS)
def test_quantizer_matches_jax_bit_for_bit(model, params, kv):
    """The same values through both quantizers: equal codes (fp8 compared
    through its uint8 bits) and equal scales, rows of zeros, ties at
    half-steps and values at the range's edge included."""
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((6, 5, 4, 8)).astype(np.float32)
    vals *= np.float32(10.0) ** rng.integers(-3, 3, (6, 5, 4, 1))
    vals[0, 0] = 0.0
    vals[1, 1, :, 0] = 127.0                      # amax: scale exactly 1
    vals[1, 1, :, 1:] = np.arange(7) - 2.5        # half-steps at scale 1
    eng = engine(model, slots=1, segment=1, kv_dtype=kv)
    jeng = jax_engine(params, slots=1, segment=1, kv_dtype=kv)
    q, s = eng._quantize(torch.as_tensor(vals))
    jq, js = jeng._quantize(vals)
    assert q.dtype == (torch.int8 if kv == "int8" else torch.uint8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).view(q.numpy().dtype))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def same_pools(eng, jeng):
    """Codes equal bit for bit, scales within SCALE_RTOL, in every layer."""
    for entry, jentry in zip(eng._pools, jeng._pools):
        for i, (b, jb) in enumerate(zip(entry, jentry)):
            b = b.numpy()
            if i < 2:
                np.testing.assert_array_equal(b, np.asarray(jb).view(b.dtype))
            else:
                np.testing.assert_allclose(b, np.asarray(jb), rtol=SCALE_RTOL,
                                           atol=0)


@pytest.mark.parametrize("kv", KINDS)
def test_pool_codes_and_logits_match_jax(model, params, kv):
    """Mixed prompt shapes, then a wave of prefix hits (cover, full with
    copy-on-write, partial): after each admission the two quantized pools
    hold the same codes, the logits agree within 1e-4 and stay within the
    declared tolerance of the model-dtype pool, and greedy tokens equal
    the JAX quantized engine's."""
    eng = engine(model, slots=4, segment=3, kv_dtype=kv)
    jeng = jax_engine(params, slots=4, segment=3, kv_dtype=kv)
    ref = engine(model, slots=4, segment=3)
    assert eng.logit_tolerance == jeng.logit_tolerance == 0.25
    waves = [[(s, p, mt, 0.0, 0) for s, (p, mt) in MIXED.items()],
             [(0, PRE + [11, 12], 6, 0.0, 0)],
             [(1, PRE + [13, 14, 15], 5, 0.0, 0), (2, PRE, 8, 0.0, 0),
              (3, PRE[:8] + [7] * 9, 4, 0.0, 0)]]
    for wave in waves:
        tracks = ({}, {}, {})
        for e, t in zip((eng, jeng, ref), tracks):
            admit_tracked(e, t, wave)
        assert eng.last_plans == jeng.last_plans
        same_pools(eng, jeng)
        logits = eng.debug_logits()
        np.testing.assert_allclose(logits, jeng.debug_logits(), atol=1e-4,
                                   rtol=1e-4)
        assert np.abs(logits - ref.debug_logits()).max() <= eng.logit_tolerance
        bufs = [np.asarray(drain(e, t)) for e, t in zip((eng, jeng, ref),
                                                        tracks)]
        same_pools(eng, jeng)
        for slot, prompt, mt, _, _ in wave:
            n = len(prompt) + mt
            assert bufs[0][slot][:n].tolist() == bufs[1][slot][:n].tolist()
    assert {s: p["hit_kind"] for s, p in eng.last_plans.items()} == {
        1: "cover", 2: "full", 3: "partial"}
    page_accounting_exact(eng)


@pytest.mark.parametrize("kv", KINDS)
def test_quantized_signature_within_tolerance(model, kv):
    """tests/test_continuous.py::test_int8_signature_within_tolerance_solo
    in the port: a quantized engine in lockstep with a model-dtype one,
    through mid-flight admission and a full-prompt hit (copy-on-write),
    keeps every slot's next-token logits within the declared tolerance,
    and (this model) greedy tokens still equal solo generate()."""
    ref = engine(model, slots=4, segment=2)
    q = engine(model, slots=4, segment=2, kv_dtype=kv)
    wave1 = [(0, PRE + [7, 7], 4, 0.0, 0), (1, [5, 5, 9, 2], 8, 0.0, 1)]
    for e in (ref, q):
        e.admit(wave1)
    for _ in range(3):
        assert np.abs(ref.debug_logits() - q.debug_logits()).max() \
            <= q.logit_tolerance
        for e in (ref, q):
            e.run_segment()
    for e in (ref, q):
        e.admit([(2, PRE, 6, 0.0, 2)])
    assert q.cow_copies == 1 and q.prefix_hits == 1
    for step in range(12):
        if step in (0, 5, 11):
            assert np.abs(ref.debug_logits() - q.debug_logits()).max() \
                <= q.logit_tolerance
        for e in (ref, q):
            e.run_segment()
    buf, _ = q.poll()
    assert buf[0][:22].tolist() == solo(model, PRE + [7, 7], 4)
    assert buf[2][:22].tolist() == solo(model, PRE, 6)
    page_accounting_exact(q)


class _SeedSpy:
    """Stands in for the engine's model: records the scratch caches each
    prefill pass is handed, then runs the model."""

    def __init__(self, model):
        self.model, self.seen = model, []

    def __call__(self, tokens, positions, caches):
        self.seen.append((int(positions[0]),
                          [(k.clone(), v.clone()) for k, v in caches]))
        return self.model(tokens, positions, caches)

    def __getattr__(self, name):
        return getattr(self.model, name)


@pytest.mark.parametrize("kv", KINDS)
def test_seeded_prefill_attends_dequantized_values(model, params, kv):
    """A partial hit on a quantized pool seeds the prefill's scratch caches
    at [0, h) with the shared pages' dequantized values (codes times
    scales, in the model dtype), as the JAX engine's ``_admit_group``
    does: the fresh pages it writes then hold the JAX engine's codes."""
    eng = engine(model, slots=2, segment=3, kv_dtype=kv)
    jeng = jax_engine(params, slots=2, segment=3, kv_dtype=kv)
    for e in (eng, jeng):
        e.admit([(0, PRE, 4, 0.0, 0)])
    spy = eng.model = _SeedSpy(eng.model)
    prompt = PRE[:8] + [7] * 9
    for e in (eng, jeng):
        e.admit([(1, prompt, 4, 0.0, 0)])
    assert eng.last_plans[1]["hit_kind"] == "partial"
    (start, caches), = spy.seen
    assert start == 8
    shared = torch.as_tensor(eng._slot_pages[1][:1])
    for (sk, sv), (kp, vp, ks, vs) in zip(caches, eng._pools):
        for seed, codes, scale in ((sk, kp, ks), (sv, vp, vs)):
            want = (codes[shared].view(eng._qdt).float()
                    * scale[shared][..., None]).to(eng.cfg.dtype)
            assert torch.equal(seed[:, :8], want.reshape(1, 8, 4, 8))
            assert not seed[:, 8:].any()
    same_pools(eng, jeng)
