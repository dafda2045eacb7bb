"""Port parity: the bf16 and int8 artifacts of ``cli export_model`` against
the eager decode, and ``CaptionService(exported=...)`` and ``cli serve
--exported`` against ``acvae_tpu``'s (``tests/test_serve.py``); the
artifacts are made as in ``tests/test_torch_export.py``.
"""
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from acvae_tpu_torch.cli.main import main
from acvae_tpu_torch.serve import CaptionService, run_server
from acvae_tpu_torch.serve import main as serve_main
from tests.test_torch_decode import FDIM, TMEL, one_torch_thread  # noqa: F401
from tests.test_torch_export import check_round_trip, export_tiny


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return export_tiny(tmp_path_factory, ("beam_bf16", "beam_int8"))


@pytest.mark.parametrize("mode", ["beam_bf16", "beam_int8"])
def test_export_round_trip(tiny, mode):
    check_round_trip(tiny, mode)


def test_caption_service_from_export(tiny, tmp_path, capsys):
    """``tests/test_serve.py::test_caption_service_from_export``: the
    service takes the vocabulary and the decode from the artifact alone,
    a fresh one repeats its captions, uint8 requests are dequantized on
    the host, a pinned batch wins over ``batch_size`` with a note, and
    the HTTP front end answers."""
    _, _, exp, arts = tiny
    svc = CaptionService(None, batch_size=4, exported=arts["beam_int8"],
                         device="cpu")
    assert svc.bucket == TMEL and svc.data_dim == FDIM and svc.exported
    rng = np.random.default_rng(3)
    mels = [rng.normal(size=(t, FDIM)).astype(np.float32) for t in (TMEL, 40, 80)]
    caps = svc.caption(mels)
    assert len(caps) == 3 and all(isinstance(c, str) for c in caps)
    assert CaptionService(None, batch_size=4, exported=arts["beam_int8"],
                          device="cpu").caption(mels) == caps
    with pytest.raises(ValueError):
        svc.caption([np.zeros((16, 7), np.float32)])
    lo, hi = float(mels[1].min()), float(mels[1].max())
    q = np.clip(np.round((mels[1] - lo) / ((hi - lo) / 255)), 0, 255).astype(np.uint8)
    deq = q.astype(np.float32) * np.float32((hi - lo) / 255) + np.float32(lo)
    seed = svc._seed                    # the same noise for both batches
    ours = svc.caption([(q, (hi - lo) / 255, lo)])
    svc._seed = seed
    assert ours == svc.caption([deq])
    # a pinned batch (greedy, 1 step: a quick export)
    pinned = main(["export_model", exp, "--device=cpu", "--max_length=1",
                   "--decode_method=greedy", "--batch_size=2",
                   f"--t_mel={TMEL}", f"--output_dir={tmp_path / 'pinned'}"])
    assert json.load(open(os.path.join(pinned, "meta.json")))["batch"] == "2"
    capsys.readouterr()
    psvc = CaptionService(None, batch_size=4, exported=pinned, device="cpu")
    assert psvc.batch_size == 2
    assert "pins batch=2; ignoring --batch_size=4" in capsys.readouterr().err
    server = run_server(svc, port=0, block=False, max_wait_ms=5.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        health = json.loads(urllib.request.urlopen(f"{url}/health",
                                                   timeout=30).read())
        assert health["status"] == "ok" and health["mel_bucket"] == TMEL
        req = urllib.request.Request(
            f"{url}/caption", data=json.dumps({"mel": mels[0].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        assert isinstance(json.loads(urllib.request.urlopen(
            req, timeout=120).read())["caption"], str)
    finally:
        server._acvae_stop()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("flags,names", [
    (["--group_size=2"], "group_size"),
    (["--beam_size=5", "--decode_dtype=bfloat16"], "beam_size, --decode_dtype")],
    ids=["decode_kwarg", "flags"])
def test_cli_serve_exported_rejects_decode_kwargs(tiny, flags, names):
    """``tests/test_serve.py::test_cli_serve_exported_rejects_decode_kwargs``:
    a changed decode flag or a decode kwarg beside ``--exported`` raises
    JAX's message, in ``cli serve``, in ``python -m ...serve`` and in
    ``CaptionService``."""
    from acvae_tpu.cli.main import Runner

    out = tiny[3]["beam_int8"]
    kw = {k: v for k, v in (f[2:].split("=") for f in flags)}
    kw = {k: int(v) if v.isdigit() else v for k, v in kw.items()}
    with pytest.raises(ValueError) as jerr:
        Runner().serve(exported=out, batch_size=2, **kw)
    assert names in str(jerr.value) and "do not apply" in str(jerr.value)
    with pytest.raises(ValueError) as perr:
        main(["serve", f"--exported={out}", "--device=cpu", "--batch_size=2",
              *flags])
    assert str(perr.value) == str(jerr.value)
    argv = ["--exported", out, "--device", "cpu"]
    for f in flags:
        argv += f.split("=")
    with pytest.raises(ValueError) as serr:
        serve_main(argv)
    assert str(serr.value) == str(jerr.value)
    with pytest.raises(ValueError) as cerr:
        CaptionService(exported=out, device="cpu", batch_size=2, **kw)
    assert str(cerr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="experiment dir or --exported"):
        main(["serve", "--device=cpu"])
