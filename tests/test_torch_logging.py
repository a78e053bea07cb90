"""PyTorch port, TensorBoard logging (``quickvc_tpu_torch/utils/logging.py``):
the event files the port writes by hand read back through TensorBoard's own
``EventAccumulator`` (tags, steps and values of scalars, images, audio and
histograms), every record's masked CRC-32C agrees with tensorboardX's, the
PNG and WAV payloads decode, and the module imports and writes with
tensorboard, tensorboardX, matplotlib, protobuf and soundfile blocked.
"""

import io
import struct
import subprocess
import sys
import types
import wave
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def accumulator(monkeypatch):
    """TensorBoard's reader on its own stub of TensorFlow (TensorBoard picks
    the stub when ``tensorboard.compat.notf`` imports), so the test does not
    import TensorFlow."""
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    def read(path):
        acc = EventAccumulator(str(path), size_guidance={"scalars": 0, "images": 0,
                                                         "audio": 0, "histograms": 0})
        acc.Reload()
        return acc
    return read


def records(path: Path) -> list[tuple[bytes, int, bytes, int]]:
    """(length bytes, its masked CRC, data, its masked CRC) of each TFRecord."""
    raw, out, i = path.read_bytes(), [], 0
    while i < len(raw):
        length = raw[i : i + 8]
        n = struct.unpack("<Q", length)[0]
        (crc_len,) = struct.unpack("<I", raw[i + 8 : i + 12])
        data = raw[i + 12 : i + 12 + n]
        (crc_data,) = struct.unpack("<I", raw[i + 12 + n : i + 16 + n])
        out.append((length, crc_len, data, crc_data))
        i += 16 + n
    assert i == len(raw)
    return out


def test_summarizer_reads_back_with_tensorboard(tmp_path, accumulator):
    from tensorboardX.record_writer import masked_crc32c as tbx_masked_crc32c

    from quickvc_tpu_torch.utils.logging import Summarizer, plot_spectrogram

    rng = np.random.default_rng(0)
    spec = rng.standard_normal((80, 37)).astype(np.float32)
    img = plot_spectrogram(spec)
    assert img.dtype == np.uint8 and img.shape == (160, 74, 3)
    wav = (0.5 * np.sin(np.arange(4000) * 0.05)).astype(np.float32)
    hist = rng.standard_normal(500)
    w = Summarizer(str(tmp_path))
    w.scalars(3, {"loss/g/total": 1.25, "loss/d/r": np.array([0.5, 0.25]),
                  "time/step_p50": np.float32(0.125)})
    w.scalars(4, {"loss/g/total": -2.5})
    w.images(3, {"slice/mel_org": img})
    w.audios(5, {"gen/audio_0": wav}, 16000)
    w.histograms(6, {"weights": hist})
    w.close()

    acc = accumulator(tmp_path)
    tags = acc.Tags()
    assert set(tags["scalars"]) == {"loss/g/total", "loss/d/r/0", "loss/d/r/1", "time/step_p50"}
    assert [(e.step, e.value) for e in acc.Scalars("loss/g/total")] == [(3, 1.25), (4, -2.5)]
    assert [e.value for e in acc.Scalars("loss/d/r/1")] == [0.25]
    (im,) = acc.Images("slice/mel_org")
    assert (im.step, im.width, im.height) == (3, 74, 160)
    (au,) = acc.Audio("gen/audio_0")
    assert (au.step, au.sample_rate, au.length_frames, au.content_type) == (
        5, 16000.0, 4000, "audio/wav")
    with wave.open(io.BytesIO(au.encoded_audio_string)) as f:
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        assert (f.getframerate(), f.getnchannels(), f.getsampwidth()) == (16000, 1, 2)
    np.testing.assert_allclose(pcm / 32767, wav, atol=1 / 32767)
    (h,) = acc.Histograms("weights")
    hv = h.histogram_value
    assert h.step == 6 and hv.num == 500 and sum(hv.bucket) == 500
    np.testing.assert_allclose([hv.min, hv.max, hv.sum, hv.sum_squares],
                               [hist.min(), hist.max(), hist.sum(), (hist ** 2).sum()])

    # the PNG decodes to the rendered image
    png = im.encoded_image_string
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    idat = png[png.index(b"IDAT") + 4 : png.index(b"IEND") - 8]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(160, 1 + 74 * 3)
    np.testing.assert_array_equal(rows[:, 1:].reshape(img.shape), img)

    # framing: each record's two masked CRC-32Cs, as tensorboardX computes them
    (path,) = tmp_path.glob("events.out.tfevents.*")
    recs = records(path)
    assert len(recs) == 6 and b"brain.Event:2" in recs[0][2]
    for length, crc_len, data, crc_data in recs:
        assert crc_len == tbx_masked_crc32c(length) and crc_data == tbx_masked_crc32c(data)


def test_plot_spectrogram_orientation_and_range():
    """Low channels at the bottom; the minimum and maximum take the table's ends."""
    from quickvc_tpu_torch.utils.logging import _COLOURS, plot_spectrogram

    spec = np.zeros((4, 3))
    spec[0] = 1.0                         # the lowest channel at the maximum
    img = plot_spectrogram(spec)
    assert img.shape == (8, 6, 3)
    assert (img[-2:] == _COLOURS[255]).all() and (img[:-2] == _COLOURS[0]).all()
    assert (plot_spectrogram(np.full((2, 2), 3.0)) == _COLOURS[0]).all()


def test_logging_needs_no_tensorboard_packages(tmp_path):
    """With tensorboard, tensorboardX, matplotlib, protobuf and soundfile
    blocked, the module imports, renders and writes a file that parses."""
    code = f"""
import sys
for name in ("tensorboard", "tensorboardX", "matplotlib", "google.protobuf", "soundfile"):
    sys.modules[name] = None
import numpy as np
from quickvc_tpu_torch.utils.logging import Summarizer, plot_spectrogram
w = Summarizer({str(tmp_path)!r})
w.scalars(1, {{"a": 1.0}})
w.images(1, {{"m": plot_spectrogram(np.eye(8))}})
w.audios(1, {{"x": np.zeros(160)}}, 16000)
w.histograms(1, {{"h": np.arange(10.0)}})
w.close()
print(w.path)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    path = Path(proc.stdout.strip().splitlines()[-1])
    assert len(records(path)) == 5
