"""The port's training CLI end to end on the CPU (`--device cpu`), with tiny
tganv2_cond specs written for the JAX package (`txt2vid_tpu.*` names, which
resolve to the port) and a synthetic dataset the port wrote itself:
run_tganv2_cond.sh's flags at this size plus --gp_lambda 0.5 --gp_every 2
--clip_grad 100 --g_ema 0.999. Also the data layer against the JAX
package's, the spec resolution and the flags that raise.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from txt2vid_tpu.data import synthetic as jax_synthetic
from txt2vid_tpu.data import transform_frames as jax_transform_frames
from txt2vid_tpu.data import collate as jax_collate
from txt2vid_tpu_torch import config
from txt2vid_tpu_torch.data import (build_vocab, collate, get_loader, load_pickle, main,
                                    my_dataset, transform_frames)
from txt2vid_tpu_torch.data import synthetic
from txt2vid_tpu_torch.data.synthetic import generate_examples
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.gan import trainer
from txt2vid_tpu_torch.models import tganv2, txt
from txt2vid_tpu_torch.train import gan
from txt2vid_tpu_torch.utils import checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny models run on one intra-op thread: beside other test
    processes, torch's thread pool oversubscribes the cores and runs many
    times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

G = {"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
     "args": {"latent_size": 16, "width": 16, "height": 16, "fm_channels": 16,
              "additional_blocks": [8], "num_frames": 4, "use_pallas": False}}
D = {"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim",
     "args": {"discrim_down_blocks": [1, 1], "num_channels": 3}}
S = {"class": "txt2vid.models.txt.basic.Seq2Seq",
     "args": {"embed_size": 16, "hidden_size": 16, "num_layers": 1}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    generate_examples(d / "videos", d / "sent.pickle", num_examples=16, frame_size=(32, 32),
                      num_frames=4, seed=5, num_channels=3)
    main(type("A", (), {"sents": str(d / "sent.pickle"), "out": str(d / "vocab.pickle")}))
    return d


def argv(data, out, *extra):
    spec = {"class": "txt2vid_tpu.data.my_dataset",
            "args": {"data": str(data / "videos"), "num_frames": 4}}
    return ["--device", "cpu", "--G", json.dumps(G), "--D", json.dumps(D),
            "--sent", json.dumps(S), "--data", json.dumps(spec),
            "--anno", str(data / "sent.pickle"), "--vocab", str(data / "vocab.pickle"),
            "--frame_sizes", "8", "16", "--subsample_input", "--num_channels", "3",
            "--D_loss", "txt2vid_tpu.gan.losses.RSGANLoss", "--G_lr", "0.0002",
            "--D_lr", "0.0002", "--G_beta2", "0.999", "--D_beta2", "0.999",
            "--gp_lambda", "0.5", "--gp_every", "2", "--clip_grad", "100",
            "--g_ema", "0.999", "--batch_size", "4", "--seed", "3", "--workers", "1",
            "--save_model_period", "3", "--log_period", "1", "--save_example_period", "3",
            "--sample_batch_size", "2", "--out", str(out), "--out_samples",
            str(out / "samples"), *extra]


def _iters(out):
    return sorted(int(p.name.split("_")[1]) for p in out.iterdir()
                  if p.name.startswith("iter_") and not p.name.endswith(".ema"))


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """Two epochs of 4 batches (8 steps, GP on 0, 2, 4, 6), then --resume for one."""
    out = tmp_path_factory.mktemp("run")
    gan.cli(argv(data, out, "--epochs", "2", "--use_writer"))
    first = _iters(out)
    gan.cli(argv(data, out, "--epochs", "1", "--resume"))
    return out, first


def test_checkpoints_and_grids(trained):
    out, first = trained
    assert first == [3, 6, 8]
    names = {p.name for p in (out / "samples").iterdir()}
    for it, ep in ((3, 0), (6, 1)):
        for tag in ("fake_samples", "fake_ema_samples"):
            assert f"{tag}_epoch_{ep:03d}_iter_{it:06d}_16x16.png" in names
    assert "real_samples.png" in names and "sentences_epoch000_iter_000003.txt" in names
    saved = [p for p in out.iterdir() if p.name.startswith("iter_") and p.suffix != ".ema"]
    assert saved and all(p.with_name(p.name + ".ema").exists() for p in saved)
    grid = (out / "samples" / "fake_samples_epoch_000_iter_000003_16x16.png").read_bytes()
    assert grid.startswith(b"\x89PNG\r\n\x1a\n")
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert {(x["tag"], x["step"]) for x in lines} >= {("loss/discrim", 1), ("grad_norm/gen", 8)}


def test_resume_continues_the_numbering(trained):
    out, _ = trained
    assert _iters(out) == [3, 6, 8, 9, 12]
    tree = checkpoint.restore_state(
        {"step": np.zeros((), np.int32)}, checkpoint.latest_checkpoint(out))
    assert int(tree["step"]) == 12


def test_png_grid_decodes():
    from PIL import Image
    import io
    v = np.random.default_rng(0).uniform(-1, 1, (2, 3, 5, 7, 3)).astype(np.float32)
    grid = trainer.to_grid(v)
    img = np.asarray(Image.open(io.BytesIO(trainer.png_bytes(grid))))
    np.testing.assert_array_equal(img, grid)
    gray = trainer.to_grid(v[..., :1])
    img = np.asarray(Image.open(io.BytesIO(trainer.png_bytes(gray))))
    np.testing.assert_array_equal(img, gray[..., 0])


def test_test_mode_writes_samples(trained, data):
    out, _ = trained
    gan.cli(argv(data, out, "--resume", "--test", "--num_samples", "2",
                 "--out_samples", str(out / "test")))
    names = {p.name for p in (out / "test").iterdir()}
    for i in range(2):
        assert {f"real_{i}.png", f"sentences_{i}.txt", f"fake_{i}_16x16.png",
                f"fake_ema_{i}_16x16.png"} <= names


def test_nan_abort_exits_42_and_keeps_the_last_good_checkpoint(data, tmp_path, monkeypatch):
    """A NaN D loss from step 5 on: the drain at the iteration-6 save finds
    it, the run exits 42, and only the iteration-3 checkpoint is on disk,
    finite."""
    calls = []
    plain = port_losses.RSGANLoss.discrim_loss

    def poisoned(self, fake=None, real=None):
        # 6 calls per step: three pairings at each of the two scales
        out = plain(self, fake=fake, real=real)
        calls.append(1)
        return out * float("nan") if len(calls) > 4 * 6 else out

    monkeypatch.setattr(port_losses.RSGANLoss, "discrim_loss", poisoned)
    with pytest.raises(SystemExit) as e:
        gan.cli(argv(data, tmp_path, "--epochs", "2", "--log_period", "0"))
    assert e.value.code == 42
    assert _iters(tmp_path) == [3]
    with open(checkpoint.latest_checkpoint(tmp_path), "rb") as f:
        raw = checkpoint.msgpack.unpackb(f.read())

    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif t is not None:
            yield np.asarray(t)
    assert all(np.isfinite(a).all() for a in leaves(raw) if a.dtype.kind == "f")


@pytest.mark.parametrize("flag", [["--sp", "2"], ["--fsdp", "2"], ["--multihost"]])
def test_unported_flags_raise_naming_themselves(data, tmp_path, flag):
    with pytest.raises(NotImplementedError, match=flag[0]):
        gan.cli(argv(data, tmp_path, *flag))


def packed_spec(data):
    """The clips of `data` packed into one T2VC file, as a --data spec."""
    from txt2vid_tpu_torch.data import packed
    path = data / "clips.t2vc"
    if not path.exists():
        packed.pack_directory(data / "videos", path)
    return json.dumps({"class": "txt2vid_tpu.data.packed.packed_dataset",
                       "args": {"data": str(path), "num_frames": 4}})


@pytest.mark.parametrize("flag", [
    ["--sgd"], ["--end2end"], ["--end2end_d_only"], ["--gen_steps", "2"],
    ["--device_data"], ["--steps_per_dispatch", "2"], ["--gen_steps", "3"],
    ["--steps_per_dispatch", "4"]])
def test_ported_flags_train(data, tmp_path, monkeypatch, flag):
    """Each single-card lever of the JAX CLI trains on the CPU: one epoch of
    two batches of 8 (--steps_per_dispatch 4: one chunk of four batches of
    4; --device_data: two steps on the packed clips, assembled from the
    device cache), finite losses, and its mark on the final checkpoint:
    --sgd's trace, end2end's "txt" moments (in both optimizers, or D's alone)
    and a moved encoder, gen_steps N updates of G per step."""
    from flax import serialization
    made, start = [], []
    orig = gan.build_train_step

    def build(gan_, *a, **kw):
        start.append(gan_.cond_encoder.encoder.embed.weight.detach().clone())
        made.append(orig(gan_, *a, **kw))
        return made[-1]

    monkeypatch.setattr(gan, "build_train_step", build)
    name, k = flag[0], int(flag[1]) if len(flag) > 1 else 1
    batch = 4 if flag == ["--steps_per_dispatch", "4"] else 8
    args = argv(data, tmp_path, "--epochs", "1", "--batch_size", str(batch), *flag)
    if name == "--device_data":
        args[args.index("--data") + 1] = packed_spec(data)
    logged = []
    monkeypatch.setattr(trainer, "status", lambda msg: logged.append(msg))
    gan.cli(args)
    (step,) = made
    steps = 4 if batch == 4 else 2
    assert step.step == steps and _iters(tmp_path) == [steps]
    losses = [m for m in logged if "Loss_D" in m]
    assert losses and all("nan" not in m and "inf" not in m for m in losses)
    with open(checkpoint.latest_checkpoint(tmp_path), "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    opt_g, opt_d = raw["opt_g_state"]["0"], raw["opt_d_state"]["0"]
    if name == "--sgd":
        assert isinstance(step.opt_g, torch.optim.SGD) and set(opt_g) == {"trace"}
        assert np.abs(opt_d["trace"]["d"]["0"]["discrim"]["fc"]["kernel"]).max() > 0
        return
    assert int(opt_d["count"]) == steps
    assert int(opt_g["count"]) == steps * (k if name == "--gen_steps" else 1)
    e2e = name.startswith("--end2end")
    assert ("txt" in opt_d["mu"]) == e2e and ("txt" in opt_g["mu"]) == (name == "--end2end")
    assert torch.equal(step.gan.cond_encoder.encoder.embed.weight.detach(), start[0]) != e2e


@pytest.mark.parametrize("flag", [["--bf16"], ["--bf16_nu"], ["--bf16_params"]])
def test_bf16_flags_run(data, tmp_path, monkeypatch, flag):
    """Each bf16 flag, one epoch of two steps (the GP on the first): --bf16
    builds G and D in bf16 and stores Adam's first moment bf16, --bf16_nu the
    second, --bf16_params runs the step from a bf16 parameter copy. The
    parameters and the caption encoder stay float32, and the checkpoint holds
    the moments under flax's bfloat16 name."""
    from flax import serialization
    made = []
    orig = gan.build_train_step
    monkeypatch.setattr(gan, "build_train_step",
                        lambda *a, **k: made.append(orig(*a, **k)) or made[-1])
    gan.cli(argv(data, tmp_path, "--epochs", "1", "--batch_size", "8", *flag))
    (step,) = made
    assert step.step == 2
    bf16, nu, params = (flag[0] == f for f in ("--bf16", "--bf16_nu", "--bf16_params"))
    want = torch.bfloat16 if bf16 else None
    assert step.gan.gen.dtype == want and step.gan.discrims[0].dtype == want
    assert step.config.compute_dtype == (torch.bfloat16 if params else None)
    for m in (step.gan.gen, step.gan.discrims[0], step.gan.cond_encoder):
        assert all(p.dtype == torch.float32 for p in m.parameters())
    for opt in (step.opt_g, step.opt_d):
        for st in opt.state.values():
            assert st["exp_avg"].dtype == (torch.bfloat16 if bf16 else torch.float32)
            assert st["exp_avg_sq"].dtype == (torch.bfloat16 if nu else torch.float32)
    with open(checkpoint.latest_checkpoint(tmp_path), "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    adam = raw["opt_g_state"]["0"]
    assert adam["mu"]["g"]["fc"]["kernel"].dtype.name == ("bfloat16" if bf16 else "float32")
    assert adam["nu"]["g"]["fc"]["kernel"].dtype.name == ("bfloat16" if nu else "float32")
    assert np.isfinite(np.asarray(adam["mu"]["g"]["fc"]["kernel"], np.float32)).all()


def test_entry_point_needs_a_gpu_unless_asked(data, tmp_path):
    args = argv(data, tmp_path)[2:]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gan.cli(args)


def test_setup_turns_tf32_off(monkeypatch):
    """setup() holds float32 matmuls and convolutions to float32 whatever the
    process had set (torch's cuDNN default is TF32), as bench.py and serve.py
    do."""
    from txt2vid_tpu_torch.train.setup import setup
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seed, device = setup(gan.build_parser().parse_args(
        ["--device", "cpu", "--seed", "3", "--data", "d", "--G", "g", "--D", "d"]))
    assert (seed, device.type) == (3, "cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("spec,cls", [
    ("txt2vid_tpu.models.tganv2_cond.MultiScaleGen", tganv2.MultiScaleGen),
    ("txt2vid.models.tganv2_cond.gen.MultiScaleGen", tganv2.MultiScaleGen),
    ("txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim", tganv2.MultiScaleDiscrim),
    ("txt2vid.models.tganv2_cond.discrim.MultiScaleDiscrim", tganv2.MultiScaleDiscrim),
    ("txt2vid_tpu.models.txt.Seq2Seq", txt.Seq2Seq),
    ("txt2vid.models.txt.basic.Seq2Seq", txt.Seq2Seq),
    ("txt2vid_tpu.gan.losses.RSGANLoss", port_losses.RSGANLoss),
    ("txt2vid.gan.losses.RSGANLoss", port_losses.RSGANLoss)])
def test_spec_names_resolve_to_the_port(spec, cls):
    obj = config.create_object({"class": spec, "args": {"vocab_size": 10}}
                               if "Seq2Seq" in spec else spec)
    assert isinstance(obj, cls)
    assert type(obj).__module__.startswith("txt2vid_tpu_torch.")


def test_spec_args_carry_over():
    """use_pallas -> use_kernel, stem_impl dropped, init_method kept for
    init_from_seed, remat passed through to G and D; dtype "bfloat16" becomes
    the modules' torch.bfloat16. The families' specs carry over alike; a
    component the port lacks raises naming it."""
    d = config.create_object({"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim",
                              "args": {**D["args"], "use_pallas": False, "stem_impl": "conv",
                                       "remat": True}},
                             init_method="ortho")
    assert d.init_method == "ortho" and d.discrim.attn.use_kernel is False and d.remat
    g = config.create_object({"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
                              "args": {**G["args"], "remat": True}})
    assert g.remat
    g = config.create_object({"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
                              "args": {**G["args"], "dtype": "bfloat16"}})
    assert g.dtype == torch.bfloat16 and g.fc.compute_dtype == torch.bfloat16
    with torch.no_grad():
        video = g.eval()(torch.randn(2, 16), torch.randn(2, 256))[-1]
    assert video.dtype == torch.bfloat16 and next(g.parameters()).dtype == torch.float32
    g = config.create_object("txt2vid.models.tcwyt.gen.Gen", dtype="bfloat16",
                             init_method="ortho")
    assert type(g).__module__ == "txt2vid_tpu_torch.models.tcwyt" and g.init_method == "ortho"
    assert g.dtype == torch.bfloat16 and g.input_map.compute_dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="NoSuchModel"):
        config.create_object("txt2vid_tpu.models.tcwyt.NoSuchModel")


def test_synthetic_captions_and_layout_match_jax(tmp_path):
    """Same seed, same captions and the same clips byte for byte as the JAX
    generator: the port's glyphs are the JAX package's PIL-font glyphs."""
    ref = jax_synthetic.generate_examples(tmp_path / "jax", tmp_path / "jax.pickle",
                                          num_examples=12, frame_size=(32, 32),
                                          num_frames=8, seed=9, num_channels=3)
    got = generate_examples(tmp_path / "port", tmp_path / "port.pickle", num_examples=12,
                            frame_size=(32, 32), num_frames=8, seed=9, num_channels=3)
    assert got == ref == load_pickle(tmp_path / "port.pickle")
    for i in range(12):
        a, b = np.load(tmp_path / "jax" / f"{i}.npy"), np.load(tmp_path / "port" / f"{i}.npy")
        assert a.shape == b.shape == (8, 32, 32, 3) and a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(b, a)
        assert b.max() > 200 and (b > 0).mean() > 0.02


@pytest.mark.parametrize("size", [16, 28, 32, 64])
def test_glyph_digits_match_jax(size):
    """The glyph table resized as PIL resizes it: JAX's glyphs at every size
    that either package's generator or digit templates use, and more."""
    ref, got = jax_synthetic._glyph_digits(size), synthetic._glyph_digits(size)
    assert sorted(got) == list(range(10))
    for d in range(10):
        assert got[d][0].shape == (size, size) and got[d][0].dtype == np.uint8
        np.testing.assert_array_equal(got[d][0], ref[d][0])


def test_nearest_index_is_pils():
    from PIL import Image
    src = np.arange(16, dtype=np.uint8)[None, :].repeat(2, 0)
    for size in range(1, 130):
        ref = np.asarray(Image.fromarray(src).resize((size, 2), Image.NEAREST))[0]
        np.testing.assert_array_equal(synthetic.nearest_index(size), ref)


@pytest.mark.parametrize("frame_size,channels,normalize", [
    (16, 3, False), (16, 1, True), (48, 3, True), (None, 1, False)])
def test_transform_and_collate_match_jax(frame_size, channels, normalize):
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        transform_frames(frames, frame_size, channels, normalize),
        jax_transform_frames(frames, frame_size, channels, normalize))
    items = [(frames[:2], np.arange(1, 2 + i, dtype=np.int32)) for i in range(3)]
    for k, v in collate(items, 4).items():
        np.testing.assert_array_equal(v, jax_collate(items, 4)[k])


def test_dataset_and_loader(data):
    vocab = load_pickle(data / "vocab.pickle")
    ds = my_dataset(data=str(data / "videos"), vocab=vocab, anno=str(data / "sent.pickle"),
                    num_frames=4, frame_size=16, num_channels=3, normalize=False)
    assert len(ds) == 16
    batches = list(get_loader(ds, batch_size=5, num_workers=2, seed=1))
    assert len(batches) == 3
    b = batches[0]
    assert b["video"].shape == (5, 4, 16, 16, 3) and b["video"].dtype == np.uint8
    assert b["captions"].shape == (5, 32) and b["lengths"].dtype == np.int32
    with open(data / "vocab.pickle", "rb") as f:
        assert len(pickle.load(f)) == len(build_vocab(
            [s for v in load_pickle(data / "sent.pickle").values() for s in v]))


class _FakeStep:
    """A train step whose metrics follow a script: one grad_norm_d per step."""

    def __init__(self, norms_d, loss_d=None):
        self.step, self.norms_d, self.loss_d = 0, norms_d, loss_d or {}

    def __call__(self, batch):
        i = self.step
        self.step += 1
        return {"loss_d": torch.tensor(self.loss_d.get(i, 1.0)), "loss_g": torch.tensor(1.0),
                "grad_norm_d": torch.tensor(self.norms_d[i]), "grad_norm_g": torch.tensor(1.0)}


def _params(tmp_path, **kw):
    import argparse
    base = dict(out=str(tmp_path), out_samples=str(tmp_path / "s"), loss_window_size=20,
                log_period=0, save_model_period=0, save_example_period=0,
                save_initial=False, save_initial_examples=False, clip_grad=100.0,
                nan_abort=True, nan_abort_streak=100, nan_abort_window=200,
                nan_abort_window_count=20, g_ema=0.0, rss_limit_gb=0)
    return argparse.Namespace(**{**base, **kw})


INF = float("inf")


@pytest.mark.parametrize("case,norms,kw,loss_d,what", [
    ("loss", [1.0] * 6, {}, {3: float("nan")}, "loss"),
    ("unclipped", [1.0, INF] + [1.0] * 4, {"clip_grad": 0.0}, {}, "no --clip_grad guard"),
    ("streak", [1.0, INF, INF, INF, 1.0, 1.0], {"nan_abort_streak": 3}, {}, "consecutively"),
    ("window", [INF, 1.0] * 6, {"nan_abort_window": 10, "nan_abort_window_count": 4}, {},
     "within the last 10 steps"),
])
def test_nan_abort_triggers(tmp_path, case, norms, kw, loss_d, what):
    """The four NanAbort triggers of the metric drain (trainer.py:337-410)."""
    step = _FakeStep(norms, loss_d)
    with pytest.raises(trainer.NanAbort, match=what):
        trainer.train(train_step=step, num_epoch=1, dataset=[{}] * len(norms),
                      params=_params(tmp_path, **kw))


def test_isolated_nonfinite_norms_under_the_clip_do_not_abort(tmp_path):
    step = _FakeStep([1.0, INF, 1.0, 1.0, INF, 1.0],)
    trainer.train(train_step=step, num_epoch=1, dataset=[{}] * 6, params=_params(tmp_path))
    assert step.step == 6


def test_burst_guard_skips_the_checkpoint(tmp_path, capsys):
    """Three non-finite norms within 100 steps before a save: it is skipped
    (no state is converted or written), the run goes on."""
    step = _FakeStep([INF, INF, INF, 1.0])
    trainer.train(train_step=step, num_epoch=1, dataset=[{}] * 4,
                  params=_params(tmp_path, save_model_period=4))
    assert "skipping checkpoint at iteration 4" in capsys.readouterr().out
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("iter_")]


def test_vocab_cli_module(data, tmp_path):
    """`python -m txt2vid_tpu_torch.data --sents S --out V` in a process of its own."""
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    out = tmp_path / "v.pickle"
    res = subprocess.run([sys.executable, "-m", "txt2vid_tpu_torch.data", "--sents",
                          str(data / "sent.pickle"), "--out", str(out)], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "vocab size:" in res.stdout
    assert load_pickle(out).word2idx == load_pickle(data / "vocab.pickle").word2idx
