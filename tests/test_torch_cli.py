"""The port's a2play CLI (``audiality2_tpu_torch.cli``) against the JAX
package's (``audiality2_tpu.cli``), on the CPU.

Scripts are written to ``tmp_path``.  The dump switches print what the
JAX CLI prints; ``--native -o`` and ``--no-native -o`` write WAVs
byte-equal to the JAX CLI's; the card render (the default, and
``--gpu``) with ``device="cpu"`` (the keyword the tests pass in place
of the card) writes the WAV of ``clip(native >> 8)`` over whole
superblocks; the card render without a card and ``--shards`` exit
non-zero with a message.
"""

import io
import re
import struct
import sys

import numpy as np
import pytest
import torch

from audiality2_tpu import cli as jcli
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch import cli
from audiality2_tpu_torch.engine.device_render import SUPERBLOCK_FRAMES
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.songs import SLICE_SONG

# exported programs and a constant, a private program and constant:
# every dump switch has something to show
SCRIPT = """
def base 2
export def Tune 1.5

Voice(P V=1)
{
	struct { wtosc; filter12; panmix }
	lp 1; cutoff (P + 2); q .8
	w saw; p P; a (V * .3)
	d 40
	a 0; d 30
}
export Melody(P=0)
{
	struct { inline 0 2; panmix 2 > }
	!n 0
	6 {
		Voice (P + n * .25)
		+n 1
		d 50
	}
	d 100
}
export Song()
{
	1:Melody base
	d 500
}
"""
DUMPS = [["-x"], ["-xa"], ["-xr"], ["-x", "-xp"], ["-x", "-xh"],
         ["-xa", "-xp", "-xh"]]


@pytest.fixture
def script(tmp_path):
    p = tmp_path / "song.a2s"
    p.write_text(SCRIPT)
    return str(p)


def _run(main, argv, capsys, **kw):
    rc = main(argv, **kw)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _dump_lines(text):
    """Output without the render summaries (whose program name and
    timings differ)."""
    return [ln for ln in text.splitlines()
            if not re.match(r"a2play-(tpu|gpu): ", ln)]


@pytest.mark.parametrize("switches", DUMPS, ids=lambda s: "".join(s))
def test_dump_switches_match_jax(script, switches, capsys):
    argv = switches + ["-st", "0", script]
    jrc, jout, _ = _run(jcli.main, argv, capsys)
    rc, out, _ = _run(cli.main, argv, capsys, device="cpu")
    assert rc == jrc == 0
    assert _dump_lines(out) == _dump_lines(jout)
    assert len(_dump_lines(out)) > 3


@pytest.mark.parametrize("engine", ["--native", "--no-native"])
def test_wav_byte_equal_to_jax(script, engine, tmp_path, capsys):
    jwav, wav = tmp_path / "jax.wav", tmp_path / "port.wav"
    common = [engine, "-c", "2", "-st", "0.4"]
    assert _run(jcli.main, common + ["-o", str(jwav), script], capsys)[0] \
        == 0
    rc, out, _ = _run(cli.main, common + ["-o", str(wav), script], capsys,
                      device="cpu")
    assert rc == 0 and "wrote" in out
    data = wav.read_bytes()
    assert data == jwav.read_bytes()
    assert len(data) > 44 + 4 * 17000
    assert np.abs(np.frombuffer(data[44:], "<i2")).max() > 0


def _card_wav_is_clipped_native(switches, script, tmp_path, capsys):
    wav = tmp_path / "gpu.wav"
    secs = 0.5
    rc, out, _ = _run(cli.main, switches + ["-c", "2", "-st", str(secs),
                                            "-o", str(wav), script],
                      capsys, device="cpu")
    assert rc == 0 and "x realtime" in out
    # render() records superblocks of min(frames, SUPERBLOCK_FRAMES)
    # rounded down to whole fragments; native runs the same ones
    frames = int(secs * 44100)
    sb = min(frames, SUPERBLOCK_FRAMES) // 64 * 64
    i = a2t.open_engine(44100, 4096, 2, batched=False)
    # loaded before the renderer is made, as the CLI does: a native
    # renderer made before the load renders it otherwise
    song = i.get(i.load(script), "Song")
    nat = NativeRenderer(i, channels=2)
    nat.timestamp_reset()
    nat.start(0, song)
    want = np.concatenate([nat.run(sb) for _ in range(-(-frames // sb))],
                          axis=1)[:, :frames]
    nat.close()
    pcm = np.clip(want.T.reshape(-1) >> 8, -32768, 32767).astype("<i2")
    data = wav.read_bytes()
    assert data[44:] == pcm.tobytes()
    assert np.abs(pcm).max() > 0


def test_gpu_flag_on_cpu_writes_clipped_native(script, tmp_path, capsys):
    _card_wav_is_clipped_native(["--gpu"], script, tmp_path, capsys)


def test_default_renders_on_the_card(script, tmp_path, capsys):
    """No engine switch: the card renders (here its plain versions on the
    CPU), as --gpu does."""
    _card_wav_is_clipped_native([], script, tmp_path, capsys)


# an EP-7 MIDI handler (tests/test_torch_host_engine.py's MIDI_SRC)
MIDI_SCRIPT = """
Tone(P V) { struct { wtosc } w sine; p P; a V; set a; d 2000; end }
export H() { struct { } d 100000; end
  7(Msg Ch A1 A2) { ifg (Msg - .5) { ifl (Msg - 1.5) { :Tone (A1 - 5) A2 } } }
}
"""


def test_midi_file_wav_byte_equal_to_jax(tmp_path, capsys):
    """-M: the program as the MIDI handler, fed a Standard MIDI File (a
    note on and off) on the host engine."""
    track = (b"\x00\xff\x51\x03\x07\xa1\x20" b"\x00\x90\x3c\x64"
             b"\x60\x80\x3c\x00" b"\x00\xff\x2f\x00")
    mid = tmp_path / "t.mid"
    mid.write_bytes(b"MThd" + struct.pack(">IHHH", 6, 0, 1, 96) + b"MTrk"
                    + struct.pack(">I", len(track)) + track)
    script = tmp_path / "h.a2s"
    script.write_text(MIDI_SCRIPT)
    wavs = []
    for main, kw in ((jcli.main, {}), (cli.main, {"device": "cpu"})):
        wav = tmp_path / ("%d.wav" % len(wavs))
        assert _run(main, ["-M", str(mid), "-p", "H", "-st", "0.5", "-o",
                           str(wav), str(script)], capsys, **kw)[0] == 0
        wavs.append(wav.read_bytes())
    assert wavs[0] == wavs[1]
    assert np.abs(np.frombuffer(wavs[1][44:], "<i2")).max() > 0


def test_live_session_writes_audio(tmp_path, capsys, monkeypatch):
    """--live: events read from stdin (a note on, a wait, its note off),
    rendered realtime-paced, then the session WAV."""
    script = tmp_path / "h.a2s"
    script.write_text(MIDI_SCRIPT)
    wav = tmp_path / "live.wav"
    monkeypatch.setattr(sys, "stdin", io.StringIO("n 60 100\nw 100\n"
                                                  "o 60\nq\n"))
    rc, out, _ = _run(cli.main, ["--live", "-st", "0.3", "-p", "H", "-o",
                                 str(wav), str(script)], capsys,
                      device="cpu")
    assert rc == 0 and "live session" in out
    assert np.abs(np.frombuffer(wav.read_bytes()[44:], "<i2")).max() > 0


def test_gpu_without_card_names_cuda(script, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _, err = _run(cli.main, ["--gpu", "-st", "0.1", script], capsys)
    assert rc != 0 and "CUDA" in err


def test_default_without_card_names_cuda(script, capsys, monkeypatch):
    """The default render needs the card; no host render stands in."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(cli.main, ["-st", "0.1", script], capsys)
    assert rc != 0 and "CUDA" in err and "rendered" not in out


def test_gpu_excludes_host_switches(script, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--gpu", "--native", script], device="cpu")
    assert e.value.code != 0
    assert "not allowed" in capsys.readouterr().err


def test_cli_device_is_the_threads_own(tmp_path, capsys, monkeypatch):
    """main's device reaches the row batches of its own thread only:
    another thread meanwhile evaluates on RowBatch.device."""
    import threading
    from audiality2_tpu_torch.tpu import row_kernel as TRK
    monkeypatch.setattr(TRK.RowBatch, "JAX_MIN_ROWS", 0)
    seen = []
    real = TRK.rows_torch

    def spy(*a, device="cuda"):
        seen.append((threading.current_thread().name, device))
        return real(*a, device="cpu")

    # a CUDA device takes the kernel's path (rows_cuda), another rows_torch
    monkeypatch.setattr(TRK, "rows_torch", spy)
    monkeypatch.setattr(TRK, "rows_cuda", spy)
    from audiality2_tpu_torch.tpu.kernels import WaveAtlas
    atlas = WaveAtlas()
    atlas.data, atlas.version = np.arange(256, dtype=np.int32), 1
    batch = TRK.RowBatch()
    batch.add_osc(8, 0, 1 << 24, 1 << 24, 0)
    other = threading.Thread(target=lambda: batch.evaluate(atlas),
                             name="other")
    with TRK.row_device("cpu"):
        other.start()
        other.join()
    song = tmp_path / "slice.a2s"
    song.write_text(SLICE_SONG)
    assert _run(cli.main, ["--no-native", "-st", "0.2", str(song)], capsys,
                device="cpu")[0] == 0
    assert seen[0] == ("other", "cuda")
    assert {d for t, d in seen[1:]} == {"cpu"} and len(seen) > 1


def test_shards_names_roadmap(script, tmp_path, capsys):
    """--shards 2 (two shards on the CPU here) writes the same WAV as the
    solo render of the same frames."""
    solo, sharded = tmp_path / "solo.wav", tmp_path / "sharded.wav"
    common = ["-c", "2", "-st", "0.5"]
    rc, _, _ = _run(cli.main, common + ["-o", str(solo), script], capsys,
                    device="cpu")
    assert rc == 0
    rc, out, _ = _run(cli.main, ["--shards", "2"] + common
                      + ["-o", str(sharded), script], capsys, device="cpu")
    assert rc == 0 and "sharded over 2 devices" in out
    data = sharded.read_bytes()
    assert data == solo.read_bytes()
    assert len(data) == 44 + 4 * int(0.5 * 44100)
    assert np.abs(np.frombuffer(data[44:], "<i2")).max() > 0


def test_version_and_missing_program(script, capsys):
    rc, out, _ = _run(cli.main, ["-v"], capsys)
    assert rc == 0 and "Engine v" + a2t.__version__ in out
    rc, _, err = _run(cli.main, ["-p", "Nope", script], capsys, device="cpu")
    assert rc == 1 and "Nope" in err
