"""PyTorch port: the HTTP server vs the JAX package's, on the CPU.

The admission-queue tests mirror ``tests/test_serve.py``. The HTTP round
trips use that file's tiny configs on ``device="cpu"``, with the JAX
engine's random weights carried into the port's engine. Tolerances: the
written int16 mixture within 1 LSB of JAX's ``run_directory`` (float32
rounding can put a sample across a quantization step); the embedding within
1e-4 of max|jax|.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.config import (
    FXencoderConfig as JaxEncCfg,
    InferenceConfig as JaxInfCfg,
    TCNConfig as JaxTCNCfg,
)
from music_mixing_style_transfer_tpu.infer.pipeline import (
    MixingStyleTransfer as JaxMST,
    StyleTransferEngine as JaxEngine,
)
from music_mixing_style_transfer_tpu_torch import serve as pserve
from music_mixing_style_transfer_tpu_torch.config import (
    FXencoderConfig,
    InferenceConfig,
    TCNConfig,
)
from music_mixing_style_transfer_tpu_torch.data.wavio import read_wav, write_wav
from music_mixing_style_transfer_tpu_torch.infer.pipeline import StyleTransferEngine
from music_mixing_style_transfer_tpu_torch.models.weights import (
    fxencoder_from_jax,
    mixfxcloner_from_jax,
)
from music_mixing_style_transfer_tpu_torch.serve import (
    AdmissionQueue,
    QueueFullError,
    ServiceBusyError,
    StyleTransferService,
    serve,
)

torch.set_num_threads(2)
SR = 44100
ENC = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
TCN = dict(condition_dimension=16, nblocks=2, channel_width=8, kernel_size=7)
INF = dict(segment_length=8192, segment_length_ref=8192, normalize_input=False, do_not_separate=True)
INSTS = ("drums", "bass", "other", "vocals")


@pytest.fixture(scope="module")
def engines():
    jax_eng = JaxEngine(encoder_cfg=JaxEncCfg(**ENC), converter_cfg=JaxTCNCfg(**TCN), seed=5)
    eng = StyleTransferEngine(
        encoder_cfg=FXencoderConfig(**ENC), converter_cfg=TCNConfig(**TCN), device="cpu"
    )
    eng.encoder.load_state_dict(fxencoder_from_jax(jax_eng.enc_vars))
    eng.converter.load_state_dict(mixfxcloner_from_jax(jax_eng.conv_vars))
    return jax_eng, eng


def _start(service):
    httpd = serve(service, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server(engines):
    service = StyleTransferService(engines[1], InferenceConfig(**INF))
    httpd, url = _start(service)
    yield service, url
    httpd.shutdown()
    httpd.server_close()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _song(root, rng, T=12_000):
    for name in ("input", "reference"):
        for inst in INSTS:
            x = (rng.standard_normal((T, 2)) * 0.2).astype(np.float32)
            write_wav(str(root / "s1" / "separated" / name / f"{inst}.wav"), x, SR)
    return str(root) + "/"


def test_health(server):
    with urllib.request.urlopen(server[1] + "/health", timeout=60) as r:
        data = json.loads(r.read())
    assert data == {"status": "ok", "backend": "cpu", "requests": data["requests"],
                    "busy": False, "queue_depth": 0, "max_queue": 4}


def test_transfer_endpoint_matches_jax_run_directory(server, engines, tmp_path, rng):
    target = _song(tmp_path / "songs", rng)
    out = _post(server[1] + "/transfer", {"target_dir": target, "output_dir": str(tmp_path / "out") + "/"})
    assert len(out["written"]) == 1
    got, _ = read_wav(out["written"][0])
    want_path = JaxMST(engines[0], JaxInfCfg(**INF)).run_directory(target, str(tmp_path / "jax") + "/")
    want, _ = read_wav(want_path[0])
    assert got.shape == want.shape == (12_000, 2)
    lsb = np.abs(np.round(got * 32768) - np.round(want * 32768)).max()
    assert lsb <= 1, f"{lsb} LSB"


def test_embed_endpoint_matches_jax(server, engines, tmp_path, rng):
    wav = str(tmp_path / "e.wav")
    x = (rng.standard_normal((20_000, 2)) * 0.2).astype(np.float32)
    write_wav(wav, x, SR)
    emb = np.asarray(_post(server[1] + "/embed", {"wav": wav, "segment_length": 8192})["embedding"])
    assert emb.shape == (ENC["channels"][-1],)
    from music_mixing_style_transfer_tpu.data.wavio import read_wav_stereo_ct_i16

    want = np.asarray(engines[0].embed_song(read_wav_stereo_ct_i16(wav), 8192))
    assert np.abs(emb - want).max() <= 1e-4 * np.abs(want).max()


def test_warmup_endpoint(server):
    out = _post(server[1] + "/warmup", {"seconds": 0.5})
    assert out["seconds"] == 0.5 and out["cold_s"] > 0 and out["warm_s"] > 0


def test_concurrent_transfers_and_health(server, tmp_path, rng):
    """Two concurrent /transfer requests both succeed (one waits behind the
    other) and /health counts them."""
    service, url = server
    target = _song(tmp_path / "songs", rng)
    before = service.requests
    results, errors = [], []

    def run(i):
        try:
            results.append(_post(url + "/transfer", {
                "target_dir": target, "output_dir": str(tmp_path / f"out{i}") + "/"}))
        except Exception as e:  # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 2
    with urllib.request.urlopen(url + "/health", timeout=60) as r:
        h = json.loads(r.read())
    assert h["requests"] == before + 2 and h["busy"] is False and h["queue_depth"] == 0


def test_queue_full_and_warmup_busy(engines, tmp_path, rng):
    """With the slot held, /embed overflows a max_queue=0 service with 429
    (+ Retry-After) and /warmup declines with 409; once free, it serves."""
    service = StyleTransferService(engines[1], InferenceConfig(**INF), max_queue=0)
    httpd, url = _start(service)
    wav = str(tmp_path / "q.wav")
    write_wav(wav, (rng.standard_normal((20_000, 2)) * 0.2).astype(np.float32), SR)
    try:
        service.admission.acquire()  # an in-flight request
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url + "/embed", {"wav": wav, "segment_length": 8192})
            assert ei.value.code == 429
            assert ei.value.headers.get("Retry-After") == "30"
            assert json.loads(ei.value.read())["queue_depth"] == 0
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url + "/warmup", {"seconds": 0.25})
            assert ei.value.code == 409
        finally:
            service.admission.release()
        out = _post(url + "/embed", {"wav": wav, "segment_length": 8192})
        assert np.isfinite(np.asarray(out["embedding"])).all()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/nowhere", {})
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_admission_queue_unit():
    """FIFO behind one slot, reject past max_queue, warmup only when idle."""
    q = AdmissionQueue(max_queue=1)
    q.acquire()
    assert q.snapshot() == {"busy": True, "queue_depth": 0, "max_queue": 1}
    with pytest.raises(ServiceBusyError):
        q.acquire_if_idle()

    waiter_in = threading.Event()

    def waiter():
        q.acquire()
        waiter_in.set()
        q.release()

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    for _ in range(100):
        if q.snapshot()["queue_depth"] == 1:
            break
        time.sleep(0.01)
    assert q.snapshot()["queue_depth"] == 1
    with pytest.raises(QueueFullError):
        q.acquire()  # 1 running + 1 waiting == capacity
    q.release()
    assert waiter_in.wait(timeout=5)
    t.join(timeout=5)
    assert not t.is_alive()
    assert q.snapshot() == {"busy": False, "queue_depth": 0, "max_queue": 1}
    q.acquire_if_idle()
    q.release()


def test_admission_queue_fifo_ordering():
    """Three queued waiters are admitted in arrival order (tickets on a
    Condition, not lock wake-up luck)."""
    q = AdmissionQueue(max_queue=3)
    q.acquire()
    order = []

    def waiter(i):
        q.acquire()
        order.append(i)
        q.release()

    threads = []
    for i in range(3):
        t = threading.Thread(target=waiter, args=(i,), daemon=True)
        t.start()
        for _ in range(500):
            if q.snapshot()["queue_depth"] == i + 1:
                break
            time.sleep(0.005)
        assert q.snapshot()["queue_depth"] == i + 1
        threads.append(t)
    q.release()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert order == [0, 1, 2]
    assert q.snapshot() == {"busy": False, "queue_depth": 0, "max_queue": 3}


@pytest.mark.parametrize("argv", [["--sequence_parallel"],
                                  ["--data_parallel", "2", "--sequence_parallel", "--segment_halo", "64"]])
def test_multi_card_options_raise_not_yet_ported(argv, capsys):
    """The multi-card options are ported (the name predates them): what
    still raises are the JAX server's argument errors (JAX
    ``serve.py:314-324``), with the same words, before any model is built."""
    from music_mixing_style_transfer_tpu import serve as jserve

    errors = []
    for main in (jserve.main, lambda a: pserve.main(a + ["--inference_device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(list(argv))
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert errors[0] == errors[1] and "--sequence_parallel" in errors[1]
