"""The port's control plane is a verbatim copy, and the port stands
without JAX.

``audiality2_tpu_torch`` keeps byte-identical copies of the JAX
package's JAX-free modules (compiler, engine state, objects, units,
native bindings): a change on either side shows here.  In a fresh
interpreter with ``jax`` and ``audiality2_tpu`` blocked on
``sys.meta_path``, the port (its stage-tail kernel modules, the packed
format, the row kernel, the host engine's device mixer,
``profile_render`` and ``serve`` included) imports, renders the slice
and effects songs briefly on the CPU (a pipelined, chained render with
a sink and a served stream among them), and ``chip_smoke.py``'s
imports resolve."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = [
    "constants.py", "errors.py", "fixmath.py", "native.py",
    "a2s/__init__.py", "a2s/program.py", "a2s/compiler.py",
    "a2s/disasm.py",
    "objects/__init__.py", "objects/banks.py", "objects/handles.py",
    "objects/waves.py", "objects/streams.py",
    "units/__init__.py", "units/descriptors.py", "units/ramper.py",
    "units/host_units.py", "units/deferred.py",
    "engine/__init__.py", "engine/state.py", "engine/core.py",
    "engine/drivers.py", "engine/render.py", "engine/midi.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_control_plane_copy_is_verbatim(rel):
    with open(os.path.join(ROOT, "audiality2_tpu", rel), "rb") as f:
        orig = f.read()
    with open(os.path.join(ROOT, "audiality2_tpu_torch", rel), "rb") as f:
        copy = f.read()
    assert copy == orig, "audiality2_tpu_torch/%s drifted" % rel


_BLOCK = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "audiality2_tpu"):
            raise ImportError("blocked: " + name)
        return None
for m in list(sys.modules):
    if m.split(".")[0] in ("jax", "jaxlib", "audiality2_tpu"):
        del sys.modules[m]
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
"""


def _run_blocked(body):
    r = subprocess.run([sys.executable, "-c", _BLOCK % ROOT + body],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_port_imports_and_renders_without_jax():
    out = _run_blocked(r"""
import numpy as np
import audiality2_tpu_torch as a2
from audiality2_tpu_torch.cuda import build, fbdelay, filter, fm, mixer
from audiality2_tpu_torch.cuda import expand, filter_float, packed, rows
from audiality2_tpu_torch.tpu import superblock
from audiality2_tpu_torch.engine.device_render import DeviceRenderer
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.songs import EFFECTS_SONG, SLICE_SONG
from audiality2_tpu_torch import cli, profile_render, render_ab
def open_(cls, src, **kw):
    i = a2.open_engine(44100, 4096, 2, batched=False)
    s = i.get(i.load_string(src, "s"), "Song")
    r = cls(i, channels=2, **kw)
    r.timestamp_reset()
    r.start(0, s)
    return r
from audiality2_tpu_torch import serve
for src in (SLICE_SONG, EFFECTS_SONG):
    want = open_(NativeRenderer, src).run(4096)
    r = open_(DeviceRenderer, src, device="cpu")
    got = r.render(4096)
    assert (got == want).all() and not r.fell_back and np.abs(got).max() > 0
# the pipelined render: profile pass, chained dispatch, a sink
nat = open_(NativeRenderer, SLICE_SONG)
want = np.concatenate([nat.run(4096) for _ in range(3)], axis=1)
r = open_(DeviceRenderer, SLICE_SONG, device="cpu", chain_dispatch=2)
got = []
assert r.render(3 * 4096, bufsize=4096,
                sink=lambda b, n: got.append(np.stack(b))) is None
assert (np.concatenate(got, axis=1) == want).all() and not r.fell_back
i = a2.open_engine(44100, 4096, 2, batched=False)
job = serve.StreamJob(i, i.get(i.load_string(SLICE_SONG, "s"), "Song"),
                      3 * 4096, channels=2)
serve.render_multiplexed([job], bufsize=4096, device="cpu")
assert (job.output == want).all()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "audiality2_tpu")]
assert not bad, bad
print("ok")
""")
    assert out.strip().endswith("ok")


def test_port_batched_engine_and_midi_without_jax():
    """The default host engine (batched=True, rows on the host below
    JAX_MIN_ROWS) and its device mixer (device_mix=True, on the CPU)
    render, and the MIDI module parses a file, with jax and
    audiality2_tpu blocked."""
    out = _run_blocked(r"""
import os, struct, tempfile
import numpy as np
import audiality2_tpu_torch as a2
from audiality2_tpu_torch.engine.midi import parse_smf
from audiality2_tpu_torch.songs import SLICE_SONG
for use_jax in (True, False):
    i = a2.open_engine(44100, 1024, 2, use_jax=use_jax)
    s = i.get(i.load_string(SLICE_SONG, "s"), "Song")
    out = []
    i.sink_callback(lambda bufs, n: out.append(np.array(bufs[0][:n])))
    i.timestamp_reset()
    i.starta(i.root_voice(), s, [])
    for _ in range(4):
        i.run(1024)
    assert np.abs(np.concatenate(out)).max() > 0
# the device mixer of the host engine (device_mix), on the CPU
from audiality2_tpu_torch.tpu.row_kernel import row_device
with row_device("cpu"):
    i = a2.open_engine(44100, 4096, 2, device_mix=True, use_jax=False)
    s = i.get(i.load_string(SLICE_SONG, "s"), "Song")
    out = []
    i.sink_callback(lambda bufs, n: out.append(np.array(bufs[0][:n])))
    i.timestamp_reset()
    i.starta(i.root_voice(), s, [])
    i.run(4096)
    assert i.state.core.device_mixer is not None
    assert np.abs(np.concatenate(out)).max() > 0
track = (b"\x00\x90\x3c\x64" b"\x60\x80\x3c\x00" b"\x00\xff\x2f\x00")
data = (b"MThd" + struct.pack(">IHHH", 6, 0, 1, 96) + b"MTrk"
        + struct.pack(">I", len(track)) + track)
p = os.path.join(tempfile.mkdtemp(), "t.mid")
open(p, "wb").write(data)
assert len(parse_smf(p)) == 2
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "audiality2_tpu")]
assert not bad, bad
print("ok")
""")
    assert out.strip().endswith("ok")


def test_chip_smoke_imports_without_jax():
    out = _run_blocked(r"""
import chip_smoke
assert chip_smoke.main.__module__ == "chip_smoke"
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "audiality2_tpu")]
assert not bad, bad
print("ok")
""")
    assert out.strip().endswith("ok")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA device, and in a directory that holds nothing of the repo
    but the script."""
    import shutil
    import torch
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a card is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, timeout=600, cwd=cwd, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_fleet_script_is_a_copy():
    """graft_entry keeps its own copy of the dry run's fleet song."""
    import __graft_entry__
    from audiality2_tpu_torch import graft_entry
    assert graft_entry._FLEET_SCRIPT == __graft_entry__._FLEET_SCRIPT


def test_sharded_render_and_entry_without_jax():
    """With jax and audiality2_tpu blocked: the sharded render (two
    shards on the CPU, two superblocks of the slice song) equals native,
    and the voice-batched entry step runs."""
    out = _run_blocked(r"""
import numpy as np, torch
import audiality2_tpu_torch as a2
from audiality2_tpu_torch import graft_entry
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.parallel import render_sharded
from audiality2_tpu_torch.songs import SLICE_SONG
def song():
    i = a2.open_engine(44100, 4096, 2, batched=False)
    return i, i.get(i.load_string(SLICE_SONG, "s"), "Song")
i, s = song()
got = render_sharded(i, s, 2 * 4096, n_devices=2, bufsize=4096,
                     channels=2, devices=["cpu", "cpu"])
i, s = song()
nr = NativeRenderer(i, channels=2)
nr.timestamp_reset()
nr.start(0, s)
want = np.concatenate([nr.run(4096) for _ in range(2)], axis=1)
assert (got == want).all() and np.abs(got).max() > 0
fn, args = graft_entry.entry(device="cpu")
assert fn(*args).shape == (2, 64)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "audiality2_tpu")]
assert not bad, bad
print("ok")
""")
    assert out.strip().endswith("ok")
