"""The port's voice-batched helpers (``audiality2_tpu_torch/tpu/
kernels.py``) and entry points (``graft_entry.py``) on the CPU, bit for
bit against the JAX package's (``audiality2_tpu/tpu/kernels.py``,
``__graft_entry__.py``) on numpy-seeded inputs and against the host
engine's integer interpolation (``_inter_vec``).

The oscillator and its fused panmixes run through the row batch
(``cuda/rows.py``: ``rows_call``, its plain version for CPU tensors), so
these tests also hold the row math to ``wtosc_fragments`` and
``panmix_*``: the 2x oversampled Hermite in int64, the ``>> 17`` and the
stereo clamp."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import audiality2_tpu_torch as a2t
from audiality2_tpu.tpu import kernels as JK
from audiality2_tpu_torch import graft_entry
from audiality2_tpu_torch.fixmath import p2i
from audiality2_tpu_torch.tpu import kernels as K
from audiality2_tpu_torch.units.host_units import _inter_vec

V = 300


@pytest.fixture(scope="module")
def voices():
    """A saw and a sine wave's mip levels in one atlas, and V seeded
    voices over them whose phases stay inside their level: (atlas int32
    numpy, {name: int64 numpy [V]}, the levels' data per voice)."""
    i = a2t.open_engine(44100, 1024, 1)
    atlas = K.WaveAtlas()
    waves = {}
    for name in ("saw", "sine"):
        w = i.get_wave(i.get(0, name))
        atlas.add_wave(name, w)
        waves[name] = w
    data = atlas.finalize()
    rng = np.random.default_rng(11)
    p = {k: np.zeros(V, np.int64) for k in (
        "base", "ph0", "dph", "amp0", "damp", "vol0", "dvol", "pan0",
        "dpan")}
    levels = []
    for v in range(V):
        name = ("saw", "sine")[v % 2]
        w = waves[name]
        # the levels of 64 samples and more
        mm = int(rng.choice([m for m in range(w.miplevels)
                             if w.size[m] >= 64]))
        base, size = atlas.lookup(name, mm)
        span = (size - 4) << 24
        p["base"][v] = base
        p["ph0"][v] = rng.integers(0, span // 2)
        p["dph"][v] = rng.integers(0, max((span - p["ph0"][v]) // 65, 2))
        levels.append(w.data[mm].astype(np.int64))
    p["amp0"] = rng.integers(-(1 << 25), 1 << 25, V)
    p["damp"] = rng.integers(-(1 << 16), 1 << 16, V)
    p["vol0"] = rng.integers(-(1 << 25), 1 << 25, V)
    p["dvol"] = rng.integers(-(1 << 16), 1 << 16, V)
    # beyond +-1.0 in a third of the voices: the stereo clamp engages
    p["pan0"] = rng.integers(-(3 << 23), 3 << 23, V)
    p["dpan"] = rng.integers(-(1 << 14), 1 << 14, V)
    return data, p, levels


def _t(p, *names):
    return [torch.from_numpy(p[k]) for k in names]


def _j(p, *names):
    import jax.numpy as jnp
    return [jnp.asarray(p[k]) for k in names]


OSC = ("base", "ph0", "dph", "amp0", "damp")


def test_wtosc_fragments_equals_jax_and_host(voices):
    data, p, levels = voices
    got = K.wtosc_fragments(torch.from_numpy(data), *_t(p, *OSC))
    assert got.dtype == torch.int64 and got.shape == (V, 64)
    want = np.asarray(JK.wtosc_fragments(data, *_j(p, *OSC)))
    assert np.array_equal(got.numpy(), want)
    assert np.abs(want).max() > 0
    n = np.arange(64, dtype=np.int64)
    for v in range(0, V, 7):
        ph = (p["ph0"][v] + n * p["dph"][v]) >> 16
        host = (_inter_vec(levels[v], ph, p["dph"][v] >> 16)
                * (p["amp0"][v] + n * p["damp"][v])) >> 17
        assert np.array_equal(got[v].numpy(), host), v


def test_wtosc_fragments_host_reference_case():
    """tests/test_tpu_kernels.py's case: one fragment of middle C on the
    sine's first level."""
    i = a2t.open_engine(44100, 1024, 1)
    atlas = K.WaveAtlas()
    w = i.get_wave(i.get(0, "sine"))
    atlas.add_wave("sine", w)
    data = atlas.finalize()
    d32 = w.data[0].astype(np.int64)
    dph = p2i(-484777) * w.period
    ph0, amp0, damp = 12345, 1 << 24, -1000
    n = np.arange(64, dtype=np.int64)
    host = (_inter_vec(d32, (ph0 + n * dph) >> 16, dph >> 16)
            * (amp0 + n * damp)) >> 17
    base, _ = atlas.lookup("sine", 0)
    got = K.wtosc_fragments(torch.from_numpy(data), *(
        torch.tensor([x], dtype=torch.int64)
        for x in (base, ph0, dph, amp0, damp)))
    assert np.array_equal(got[0].numpy(), host)


def test_panmix_equals_jax(voices):
    _, p, _ = voices
    rng = np.random.default_rng(3)
    vin = rng.integers(-(1 << 26), 1 << 26, (V, 64))
    mono = K.panmix_mono(torch.from_numpy(vin), *_t(p, "vol0", "dvol"))
    import jax.numpy as jnp
    jmono = JK.panmix_mono(jnp.asarray(vin), *_j(p, "vol0", "dvol"))
    assert np.array_equal(mono.numpy(), np.asarray(jmono))
    st = K.panmix_stereo(torch.from_numpy(vin),
                         *_t(p, "vol0", "dvol", "pan0", "dpan"))
    jst = JK.panmix_stereo(jnp.asarray(vin),
                           *_j(p, "vol0", "dvol", "pan0", "dpan"))
    for a, b in zip(st, jst):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert (np.abs(p["pan0"]) > 0xFFFFFF).any()


def test_fused_panmix_equals_jax_chain(voices):
    """The row batch's fused forms: wtosc_fragments followed by
    panmix_mono / panmix_stereo."""
    data, p, _ = voices
    osc = JK.wtosc_fragments(data, *_j(p, *OSC))
    mono = K.wtosc_panmix_mono(torch.from_numpy(data),
                               *_t(p, *OSC, "vol0", "dvol"))
    assert np.array_equal(mono.numpy(), np.asarray(
        JK.panmix_mono(osc, *_j(p, "vol0", "dvol"))))
    st = K.wtosc_panmix_stereo(torch.from_numpy(data),
                               *_t(p, *OSC, "vol0", "dvol", "pan0", "dpan"))
    jst = JK.panmix_stereo(osc, *_j(p, "vol0", "dvol", "pan0", "dpan"))
    for a, b in zip(st, jst):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.abs(np.asarray(b)).max() > 0


def test_mix_to_buses_equals_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    vo = rng.integers(-(1 << 40), 1 << 40, (V, 64))
    bus = rng.integers(0, 7, V)
    got = K.mix_to_buses(torch.from_numpy(vo), torch.from_numpy(bus), 7)
    want = JK.mix_to_buses(jnp.asarray(vo), jnp.asarray(bus), 7)
    assert got.dtype == torch.int64 and got.shape == (7, 64)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_entry_equals_jax_entry():
    import jax
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jentry.entry()
    assert len(args) == len(jargs)
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    got = fn(*args)
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert got.shape == (2, 64)
    assert np.array_equal(got.numpy(), want)
    assert np.abs(want).max() > 0


def test_dryrun_multichip_on_cpu():
    graft_entry.dryrun_multichip(4, device="cpu")
