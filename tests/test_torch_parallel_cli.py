"""Port parity: the CLI's parallel paths (``cli train`` with
``distributed``, ``model_parallel`` and ``sequence_parallel``, and
``evaluate --distributed``) against the unsharded port and
``acvae_tpu.cli``.

Small widths (Cnn10 channels 4-8-8-16, embed/hidden 16, dropouts off) on a
rich synthetic corpus of 8 clips, on the CPU over gloo.  ``train`` starts
one worker a device; ``cli._local_devices`` is patched to hand it CPU
entries, as the card's machine hands it cards.  The launched runs are two
``python -c`` processes, each training with the launcher keys, then with
torchrun's environment, then stopped by ``fault_abort_step``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acvae_tpu.models.vae as jvae
import acvae_tpu_torch.models.vae as tvae
from acvae_tpu.cli.main import Runner
from acvae_tpu_torch.cli import main as cli
from acvae_tpu_torch.parallel import state as pstate
from acvae_tpu_torch.parallel.mesh import free_port
from acvae_tpu_torch.train.checkpoints import load_experiment
from tests.test_torch_cli import experiments, ws  # noqa: F401
from tests.test_torch_decode import eps_slab, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TINY = """\
model: Hybrid_VAEModel
alpha: 0.5
beta: 1.5
encodermodel: Cnn10
encoder_args: {{embed_size: 16, channels: [4, 8, 8, 16], conv_dropout: 0.0, head_dropout: 0.0}}
decoder: VAERNNBahdanauAttnDecoder
decoder_args: {{embed_size: 16, hidden_size: 16, dropout: 0.0}}
model_args:
  posterior_model: PosteriorRNN_hybrid
  posterior_args: {{hidden_size: 16}}
  prior_model: PriorRNN
  prior_args: {{hidden_size: 16}}
h5_csv: {root}/mels.csv
caption_file: {root}/text.json
vocab_file: {root}/vocab.pkl
outputpath: {root}/out
epochs: 1
batch_size: 8
train_percent: 75
scheduler_args: {{final_lr: 1.0e-05, warmup_iters: 3000}}
augments: [timewarp, timemask, freqmask]
"""


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 clips of 128 frames, a vocabulary padded to an even size."""
    root = tmp_path_factory.mktemp("par")
    cli.main(["make_synthetic", str(root), "--rich", "--num_audios=8",
              "--mel_frames=128", "--device=cpu"])
    cli.main(["build_vocab", str(root / "text.json"), str(root / "vocab.pkl"),
              "--pad_to_multiple=2", "--device=cpu"])
    (root / "c.yaml").write_text(TINY.format(root=root))
    return root


def _metrics(exp):
    return [json.loads(line) for line in
            (Path(exp) / "metrics.jsonl").read_text().splitlines()]


def test_spawned_tp_sp_train_matches_unsharded(corpus, monkeypatch):
    """A worker a device on a (2 data, 2 model) grid with the time split
    resumes the unsharded run stopped at step 3 after its step-2 snapshot:
    JAX's log lines; it re-splits the snapshot, its ``last`` is the full
    layout, and its second epoch is the unsharded run's: the math is the
    global batch's (loss and KL at rtol 1e-5; the mean grad norm, after two
    epochs of Adam steps' float32 sum-order drift, at 1e-4; the same
    captions' CIDEr exactly)."""
    base = ["train", str(corpus / "c.yaml"), "--device=cpu", "--epochs=2",
            "--checkpoint_every_steps=2"]
    plain = cli.main(base + ["--remark=plain"])
    with pytest.raises(SystemExit, match="injected failure at step 3"):
        cli.main(base + ["--remark=grid", "--fault_abort_step=3"])
    exp = Path(plain).parent.parent / "grid_1.5_0.5" / "seed_1"
    snap = torch.load(exp / "step_1.pt", map_location="cpu", weights_only=False)
    assert snap["step"] == 2
    monkeypatch.setattr(cli, "_local_devices",
                        lambda device: [torch.device("cpu")] * 4)
    cli.main(base + ["--distributed=true", "--model_parallel=2",
                     "--sequence_parallel=true", "--remark=grid",
                     "--resume=true"])
    log = (exp / "train_caption.log").read_text()
    assert ("data-parallel mesh: {'data': 2, 'model': 2} (vocab-dim params "
            "split over 'model')") in log
    assert "sequence parallelism: mel time sharded over 'model'" in log
    assert "at step 2 → epoch 1" in log
    conf, vocab, model = load_experiment(str(exp), "last", device="cpu")
    assert model.decoder.classifier.weight.shape[0] == len(vocab)
    got, want = _metrics(exp), _metrics(plain)
    assert [m["epoch"] for m in got] == [1, 2]
    for k, rtol in (("train_loss", 1e-5), ("kl", 1e-5), ("grad_norm", 1e-4),
                    ("val_cider", 0)):
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=rtol, err_msg=k)


@pytest.fixture(scope="module")
def launched(corpus):
    """One launched pair, each process training twice: ``model_parallel``
    1 with the launcher keys, then 2 with torchrun's environment; then a
    run with the launcher keys stopped by ``fault_abort_step``.  Each
    rank's output (final losses, the fault's message) and exit code."""
    ports = [free_port(), free_port(), free_port()]
    child = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {str(ROOT)!r})
        from acvae_tpu_torch.cli import main as cli
        rank = sys.argv[1]
        base = ["train", {str(corpus / 'c.yaml')!r}, "--device=cpu",
                "--distributed=true"]
        cli.main(base + ["--model_parallel=1", "--remark=launch1",
                         "--num_processes=2", "--process_id=" + rank,
                         "--coordinator_address=localhost:{ports[0]}"])
        print("FINAL_LOSS1 %.8f" % cli.last_train_loss)
        os.environ.update(RANK=rank, WORLD_SIZE="2", MASTER_ADDR="localhost",
                          MASTER_PORT="{ports[1]}")
        cli.main(base + ["--model_parallel=2", "--remark=launch2"])
        print("FINAL_LOSS2 %.8f" % cli.last_train_loss)
        del os.environ["RANK"], os.environ["WORLD_SIZE"]
        try:
            cli.main(base + ["--remark=fault", "--fault_abort_step=1",
                             "--num_processes=2", "--process_id=" + rank,
                             "--coordinator_address=localhost:{ports[2]}"])
        except SystemExit as e:
            print("STOPPED", e)
    """)
    env = dict(os.environ, LOCAL_WORLD_SIZE="4")   # the suite shares the cores
    procs = [subprocess.Popen([sys.executable, "-c", child, str(r)],
                              cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        return [(p.communicate(timeout=300)[0], p.returncode) for p in procs]
    finally:
        for p in procs:
            p.kill()


@pytest.mark.parametrize("mp", [1, 2])
def test_launched_train_ranks_agree(corpus, launched, mp):
    """Two processes with the launcher keys or torchrun's environment (JAX's
    multi-process CLI train, one device a process): each loads its stride
    of the corpus, the ranks
    agree on the epoch loss within 1e-5, rank 0 alone writes the run's
    files; ``model_parallel=2`` falls back to data parallelism with JAX's
    warning (one device per host)."""
    for text, rc in launched:
        assert rc == 0, text[-3000:]
    losses = [float(text.split(f"FINAL_LOSS{mp} ")[1].split()[0])
              for text, _ in launched]
    assert abs(losses[0] - losses[1]) < 1e-5 and np.isfinite(losses[0])
    found = list((corpus / "out" / "Hybrid_VAEModel").glob(
        f"launch{mp}_*/seed_1/metrics.jsonl"))
    assert len(found) == 1
    (rec,) = _metrics(found[0].parent)
    assert abs(rec["train_loss"] - losses[0]) < 1e-5
    log = (found[0].parent / "train_caption.log").read_text()
    assert "data-parallel mesh: {'data': 2}" in log
    fallback = ("model_parallel=2 does not divide the device counts (2 global, "
                "1 per host); falling back to pure data parallelism")
    assert (fallback in log) == (mp == 2)


def test_launched_fault_stops_every_rank(launched):
    """``fault_abort_step`` under a launch: every rank passes the barrier
    and stops with the message; none is left waiting in a collective."""
    for text, rc in launched:
        assert rc == 0, text[-3000:]
        assert "STOPPED fault_abort_step: injected failure at step 1" in text


@pytest.fixture
def row_fixed_eps(monkeypatch):
    """Both packages' eps_stack read EPS_SLAB's leading block; the port's
    draws it for the whole batch and keeps a shard's rows, as its real
    draws do (``parallel/state.py``)."""
    monkeypatch.setattr(jvae, "eps_stack", lambda key, steps, rows, dim,
                        dtype=None: jnp.asarray(eps_slab(steps, rows, dim)))
    monkeypatch.setattr(tvae, "eps_stack", lambda steps, rows, dim,
                        generator=None, device=None, dtype=torch.float32:
                        pstate._draw(lambda s, d: torch.tensor(eps_slab(*s)),
                                     (steps, rows, dim), 1, None, device))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_evaluate_distributed_matches_unsharded_and_jax(ws, experiments,
                                                        row_fixed_eps,
                                                        monkeypatch, int8):
    """``evaluate --distributed`` over three device entries (16 clips padded
    to 18): the captions and scores of the unsharded evaluate, and (f32)
    JAX's ``evaluate(distributed=True)`` over its 8 devices."""
    jax_exp, port_exp = experiments
    kw = dict(eval_h5_csv=str(ws / "h5.csv"),
              eval_caption_file=str(ws / "text.json"), encoder_int8=int8)
    suffix = "_int8" if int8 else ""
    files = (f"eval_output_beam_3{suffix}.json", f"scores_beam_3{suffix}.txt")
    cli.evaluate(str(port_exp), device="cpu", **kw)
    plain = [(port_exp / f).read_text() for f in files]
    monkeypatch.setattr(cli, "_local_devices",
                        lambda device: [torch.device("cpu")] * 3)
    cli.evaluate(str(port_exp), device="cpu", distributed=True, **kw)
    assert [(port_exp / f).read_text() for f in files] == plain
    if not int8:
        Runner().evaluate(str(jax_exp), distributed=True, **kw)
        caps = [{p["filename"]: p["caption"] for p in json.loads(
            (exp / files[0]).read_text())["predictions"]}
            for exp in (jax_exp, port_exp)]
        assert caps[0] == caps[1]
        assert (jax_exp / files[1]).read_text() == plain[1]


@pytest.mark.parametrize("env,rank,cards,want", [
    ({"LOCAL_RANK": "1"}, 5, 4, 1), ({"SLURM_LOCALID": "2"}, 6, 4, 2),
    ({"OMPI_COMM_WORLD_LOCAL_RANK": "3"}, 7, 4, 3), ({}, 1, 1, 0),
    ({}, 6, 4, 2)])
def test_launched_rank_takes_its_node_local_card(monkeypatch, env, rank,
                                                 cards, want):
    """Under a launcher a rank's card is the node-local rank torchrun,
    Slurm or Open MPI set, else its rank modulo the cards it sees (rank 1
    of a two-host job with a card each takes card 0)."""
    for k in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert cli._local_rank(rank) == want


@pytest.mark.parametrize("encoder,buckets,want", [
    ("Cnn14", (256, 1024, 3072), None),
    ("Cnn14", (256, 80, 1024), "sequence parallelism: Cnn14 runs on whole "
     "clips of the mel buckets [80] (its time splits in multiples of 32 x 2 "
     "frames)"),
    ("RNNEncoder", (256,), "sequence parallelism: RNNEncoder runs on "
     "whole clips (the port splits the time of CNN10CRNNEncoder, "
     "CNN10DEncoder, CNN10Encoder, CNN10QEncoder, CNNEncoder, CRNN8_Sub4, "
     "CRNNEncoder, Cnn10, Cnn14, E2EASREncoder, M2TransformerEncoder, "
     "PreTrainedCNN, ResNet38, ResNetEncoder, TransformerEncoder; a "
     "composite's when every branch splits)")],
    ids=["splits", "a_bucket_whole", "encoder_whole"])
def test_sequence_parallel_logs_whole_clips(encoder, buckets, want):
    """``train`` names what runs whole clips under ``sequence_parallel``:
    an encoder the port does not split, or the buckets whose time does not
    split over the model axis; nothing when every bucket splits."""
    from types import SimpleNamespace

    from acvae_tpu_torch.models.encoders import build_encoder
    from acvae_tpu_torch.parallel.train import Distributed
    enc = build_encoder(encoder, {}, 64, device="meta")
    par = SimpleNamespace(
        seq_params=set(map(id, getattr(enc, "seq_split_params", list)())),
        model=SimpleNamespace(encoder=enc), grid=SimpleNamespace(model=2))
    par.seq_split = lambda T: Distributed.seq_split(par, T)
    lines = []
    cli._log_whole_clips(SimpleNamespace(info=lines.append), encoder, par,
                         buckets)
    assert lines == ([] if want is None else [want])
