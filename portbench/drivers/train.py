"""Training cells: the program's training CLI on packed clips made from the
seed, its trainer bounded by the batches the harness lets through.

`txt2vid_tpu_torch.train.gan.main` builds the run from the configuration's
flags, as a user's command line does, and `gan.trainer.train` runs it with
its loader, EMA and per-step checks. The harness wraps the trainer's call
once: it loads the benchmark's weights into the built models, hands the
trainer the same EMA start the trainer makes itself, and wraps its dataset
and its step:
- steps 0-2 are the checked steps: their batches are kept, the first
  gradient is read from the optimizers after step 0 and every parameter's
  change after step 2;
- the window starts after a synchronise before step 3 and takes every step
  whose batch is asked for within `seconds`; it ends in a synchronise;
- with --trace 1 a traced segment follows (at least `trace_min_steps` steps
  and `trace_seconds`), under torch.profiler;
- then the trainer's dataset ends, and the trainer returns as after an
  epoch. Checkpoints and sample grids are off.
After the program's state is freed, the plain reference runs the three
checked steps from the same weights, batches and draws.
"""

import gc
import json
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import correct, counts, data, weights
from portbench.reference import train as ref_train
from portbench.reference.precision import precision
from portbench.trace import WINDOW, Trace

CHECKED_STEPS = 3


def argv(spec: dict, paths: dict, seed: int, out: Path, device: str) -> list[str]:
    """The training CLI's flags for a configuration."""
    g, t = spec["G"]["args"], spec["train"]
    dataset = {"class": "txt2vid_tpu_torch.data.packed.packed_dataset",
               "args": {"data": str(paths["data"]), "num_frames": g["num_frames"]}}
    a = ["--G", json.dumps(spec["G"]), "--D", json.dumps(spec["D"]),
         "--sent", json.dumps(spec["sent"]), "--data", json.dumps(dataset),
         "--anno", str(paths["anno"]), "--vocab", str(paths["vocab"]),
         "--frame_sizes", *map(str, t["frame_sizes"]), "--num_channels", str(g["num_channels"]),
         "--D_loss", t["D_loss"],
         "--G_lr", str(t["G_lr"]), "--D_lr", str(t["D_lr"]),
         "--G_beta1", str(t["G_beta1"]), "--G_beta2", str(t["G_beta2"]),
         "--D_beta1", str(t["D_beta1"]), "--D_beta2", str(t["D_beta2"]),
         "--batch_size", str(t["batch_size"]), "--epochs", "1", "--seed", str(seed),
         "--log_period", str(t["log_period"]), "--save_model_period", "0",
         "--save_example_period", "0", "--out", str(out / "out"),
         "--out_samples", str(out / "samples"), "--device", device]
    if t["subsample_input"]:
        a.append("--subsample_input")
    if t["gp_lambda"] > 0:
        a += ["--gp_lambda", str(t["gp_lambda"]), "--gp_every", str(t["gp_every"])]
    if t.get("clip_grad"):
        a += ["--clip_grad", str(t["clip_grad"])]
    if t.get("clip_grad_split"):
        a.append("--clip_grad_split")
    if t.get("g_ema"):
        a += ["--g_ema", str(t["g_ema"])]
    a += [f"--{f}" for f in ("bf16", "bf16_nu", "bf16_params") if t.get(f)]
    return a


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _norms(tensors) -> list[float]:
    if not tensors:
        return []
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).cpu().tolist()


class Session:
    """One run's state: the window's clock and counters, the checked steps'
    batches and the program's readings."""

    def __init__(self, spec, traffic, seed, seconds, trace, device, fault=None,
                 window=True):
        self.spec, self.traffic, self.seed = spec, traffic, seed
        self.seconds, self.trace, self.device, self.fault = seconds, trace, device, fault
        self.window_on = window
        self.batches, self.step_metrics = [], []
        self.program = {"grad": {}, "change": {}}
        self.data_wait_s, self.gp_ms = 0.0, []
        self.t0 = self.t1 = None
        self.window_steps, self.trace_steps = 0, []
        self.prof = self.range = None
        self.peak_bytes = None
        self.first_step = None

    # -- the benchmark's weights -------------------------------------------
    def weights(self):
        G, D, E = ref_train.build(self.spec, len(data.vocabulary()), "meta")
        return weights.model_weights({"G": G, "D": D, "E": E},
                                     weights.derive(self.seed, 1), self.device)

    def load_program(self, gan):
        w = self.weights()
        weights.load(gan.gen, weights.part(w, "G"))
        weights.load(gan.discrims[0], weights.part(w, "D"))
        weights.load(gan.cond_encoder, weights.part(w, "E"))

    # -- readings ------------------------------------------------------------
    def _named(self):
        return {"G": dict(self.gan.gen.named_parameters()),
                "D": dict(self.gan.discrims[0].named_parameters())}

    def read_first_grads(self):
        by_id = {id(p): f"{m}.{n}" for m, named in self._named().items()
                 for n, p in named.items()}
        names, moments = [], []
        for opt in (self.step.opt_g, self.step.opt_d):
            for group in opt.param_groups:
                b1 = group["betas"][0] if "betas" in group else group["b1"]
                for p in group["params"]:
                    st = opt.state.get(p, {})
                    names.append(by_id[id(p)])
                    moments.append(st["exp_avg"].float() / (1 - b1) if "exp_avg" in st
                                   else torch.zeros_like(p))
        self.program["grad"] = dict(zip(names, _norms(moments)))

    def read_after_checked(self):
        w = self.weights()
        names, diffs = [], []
        for m, named in self._named().items():
            for n, p in named.items():
                names.append(f"{m}.{n}")
                diffs.append(p.detach() - w[f"{m}.{n}"])
        if self.ema is not None:
            for n, p in self.ema.items():
                names.append(f"EMA.{n}")
                diffs.append(p - w[f"G.{n}"])
        self.program["change"] = dict(zip(names, _norms(diffs)))
        self.program["losses"] = [[float(m["loss_d"]), float(m["loss_g"])]
                                  for m in self.step_metrics[:CHECKED_STEPS]]

    # -- the window ----------------------------------------------------------
    def before(self, k: int) -> bool:
        """Called before batch k is fetched; False ends the dataset."""
        if k == 1:
            sync(self.device)
            self.read_first_grads()
        if k == CHECKED_STEPS:
            sync(self.device)
            self.read_after_checked()
            if not self.window_on:
                return False
            if torch.device(self.device).type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            self.first_step = int(self.step.step)
            self.t0 = time.perf_counter()
            return True
        if k < CHECKED_STEPS:
            return True
        if self.t1 is None:
            if time.perf_counter() - self.t0 < self.seconds:
                return True
            sync(self.device)
            self.t1 = time.perf_counter()
            self.window_steps = k - CHECKED_STEPS
            if torch.device(self.device).type == "cuda":
                self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
            if not self.trace:
                return False
            self._start_trace()
            return True
        t = self.traffic
        if (len(self.trace_steps) < t["trace_min_steps"]
                or time.perf_counter() - self.trace_start < t["trace_seconds"]):
            return True
        sync(self.device)
        self.range.__exit__(None, None, None)
        self.prof.stop()
        return False

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        cuda = torch.device(self.device).type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if cuda else []))
        self.prof.start()
        self.range = record_function(WINDOW)
        self.range.__enter__()
        self.trace_start = time.perf_counter()

    def in_window(self) -> bool:
        return self.t0 is not None and self.t1 is None

    def fetched(self, k: int, batch: dict, wait: float):
        if k < CHECKED_STEPS:
            self.batches.append({"video": batch["video"].cpu().numpy(),
                                 "captions": batch["captions"].cpu().numpy(),
                                 "lengths": np.asarray(batch["lengths"])})
        elif self.in_window():
            self.data_wait_s += wait
        if self.t1 is not None:
            self.trace_steps.append(int(self.step.step))


class Windowed:
    """The trainer's dataset: the program's LoaderAdapter, re-iterated at its
    epoch ends, for as long as the session lets batches through."""

    def __init__(self, inner, session: Session):
        self.inner, self.session = inner, session

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        s, it, k = self.session, iter(self.inner), 0
        while s.before(k):
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                it = iter(self.inner)
                batch = next(it)
            s.fetched(k, batch, time.perf_counter() - t)
            yield batch
            k += 1


class StepTap:
    """The trainer's step: the program's TrainStep, its first metrics kept,
    GP steps timed in a traced run, and a planted fault where one is asked
    for (half_batch: the step sees the first half of each batch)."""

    def __init__(self, inner, session: Session):
        self.inner, self.session = inner, session

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, batch):
        s, cfg = self.session, self.inner.config
        if s.fault == "half_batch":
            batch = {k: v[: len(v) // 2] for k, v in batch.items()}
        timed = (s.trace and s.in_window() and cfg.gp_lambda > 0
                 and self.inner.step % cfg.gp_every == 0)
        if timed:
            sync(s.device)
            t = time.perf_counter()
        metrics = self.inner(batch)
        if timed:
            sync(s.device)
            s.gp_ms.append(1e3 * (time.perf_counter() - t))
        if len(s.step_metrics) < CHECKED_STEPS:
            s.step_metrics.append(metrics)
        return metrics


def run_program(session: Session, out: Path, paths: dict):
    """The CLI in this process, its trainer wrapped; returns when it ends."""
    from txt2vid_tpu_torch.gan import ema as ema_mod
    from txt2vid_tpu_torch.gan import trainer as trainer_mod
    from txt2vid_tpu_torch.train import gan as cli
    real_train = trainer_mod.train

    def train(gan=None, train_step=None, dataset=None, params=None, ema=None, **kw):
        session.load_program(gan)
        if params.g_ema and ema is None:
            ema = ema_mod.init_ema(gan.gen)
        session.gan, session.step, session.ema = gan, train_step, ema
        if session.fault == "unchanged":
            for opt in (train_step.opt_g, train_step.opt_d):
                opt.step = lambda *a, **k: None
        return real_train(gan=gan, train_step=StepTap(train_step, session),
                          dataset=Windowed(dataset, session), params=params, ema=ema, **kw)

    trainer_mod.train = train
    try:
        cli.main(cli.build_parser().parse_args(
            argv(session.spec, paths, session.seed, out, str(session.device))))
    finally:
        trainer_mod.train = real_train
        session.gan = session.step = session.ema = None
        gc.collect()
        if torch.device(session.device).type == "cuda":
            torch.cuda.empty_cache()


def make_inputs(spec, traffic, seed, root: Path):
    """The seed's clips and captions, written for the CLI."""
    g, t = spec["G"]["args"], spec["train"]
    rng = np.random.default_rng(weights.derive(seed, 2))
    n = spec["dataset"]["clips"]
    videos = data.clips(n, (g["num_frames"], g["width"], g["width"], g["num_channels"]), rng)
    caps = data.captions(n, rng)
    return videos, caps, data.write_dataset(root, videos, caps)


def checked_inputs(session: Session, videos, caps):
    """The checked steps' batches rebuilt from the benchmark's own clips and
    captions, and the rows the loader delivered wrong (not one of the clips
    with its caption)."""
    index = {data.signature(v): i for i, v in enumerate(videos)}
    max_len = session.spec["train"]["max_caption_len"]
    rebuilt, wrong = [], 0
    for b in session.batches:
        ids = [index.get(data.signature(v), -1) for v in b["video"]]
        toks, lengths = data.tokenize([caps[i] for i in ids], max_len)
        for row, i in enumerate(ids):
            wrong += int(i < 0 or not np.array_equal(videos[i], b["video"][row])
                         or not np.array_equal(toks[row], b["captions"][row])
                         or lengths[row] != b["lengths"][row])
        rebuilt.append((videos[[max(i, 0) for i in ids]], toks, lengths))
    return rebuilt, wrong


def reference_readings(session: Session, batches, name: str) -> dict:
    """The reference's three checked steps in precision `name`."""
    device = session.device
    spec = session.spec
    with precision(name):
        w = session.weights()
        ref = ref_train.ReferenceTrainer(spec, len(data.vocabulary()), w, device)
        out = {"losses": [], "grad": {}, "change": {}}
        for i, (video, toks, lengths) in enumerate(batches):
            r = ref.step(torch.from_numpy(video).to(device), torch.from_numpy(toks),
                         torch.from_numpy(lengths), ref.draws(session.seed, len(video)))
            out["losses"].append([float(r["loss_d"]), float(r["loss_g"])])
            if i == 0:
                names = ([f"G.{n}" for n, _ in ref.G.named_parameters()]
                         + [f"D.{n}" for n, _ in ref.D.named_parameters()])
                out["grad"] = dict(zip(names, _norms(list(r["grad_g"]) + list(r["grad_d"]))))
        names, diffs = [], []
        for m, module in (("G", ref.G), ("D", ref.D)):
            for n, p in module.named_parameters():
                names.append(f"{m}.{n}")
                diffs.append(p.detach() - w[f"{m}.{n}"])
        if ref.ema is not None:
            for n, p in ref.ema.items():
                names.append(f"EMA.{n}")
                diffs.append(p - w[f"G.{n}"])
        out["change"] = dict(zip(names, _norms(diffs)))
    del ref, w
    gc.collect()
    return out


def run(spec, traffic, seed, seconds, trace, device, fault=None, control=None,
        window=True, process_start=None):
    """One run of a training cell. Returns a dict: `e2e` (end-to-end
    numbers), `layer` (what the per-layer readers read), `checks`
    (number -> (value, where)), `control_checks`, `attempted`, `failed`,
    `peak_bytes`, `trace`."""
    process_start = process_start or time.perf_counter()
    session = Session(spec, traffic, seed, seconds, trace, device, fault, window)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        root = Path(tmp)
        videos, caps, paths = make_inputs(spec, traffic, seed, root)
        run_program(session, root, paths)
    t = spec["train"]
    out = {"attempted": session.window_steps, "failed": 0, "peak_bytes": session.peak_bytes}
    if window:
        elapsed = session.t1 - session.t0
        out["e2e"] = {"train_videos_per_s": session.window_steps * t["batch_size"] / elapsed,
                      "setup_s": session.t0 - process_start,
                      "peak_mem_gib": (session.peak_bytes or 0) / 2 ** 30}
        layer = {"window_s": elapsed, "window_steps": session.window_steps,
                 "first_step": session.first_step}
        if session.window_steps:
            layer["data_wait_ms"] = 1e3 * session.data_wait_s / session.window_steps
        if session.gp_ms:
            layer["gp_step_ms"] = statistics.median(session.gp_ms)
        if trace:
            layer.update(_trace_layer(session, elapsed))
            out["trace"] = layer.get("trace")
        out["layer"] = layer

    batches, wrong = checked_inputs(session, videos, caps)
    ref = reference_readings(session, batches, "f32")
    checks = correct.train_checks(session.program, ref)
    checks["batch_rows_wrong"] = (float(wrong), "rows not one of the clips with its caption")
    out["checks"] = checks
    out["leaves"] = {"program": session.program, "reference": ref}
    if control:
        low = reference_readings(session, batches, control)
        out["control_checks"] = correct.train_checks(low, ref)
        out["leaves"]["control"] = low
    return out


def _trace_layer(session: Session, elapsed: float) -> dict:
    spec = session.spec
    t = spec["train"]
    step_counts = counts.train_step_counts(spec, len(data.vocabulary()))

    def kind(step):
        gp = t["gp_lambda"] > 0 and step % t["gp_every"] == 0
        return "gp" if gp else "plain"

    window = range(session.first_step, session.first_step + session.window_steps)
    flops = sum(step_counts[kind(s)][0] for s in window)
    layer = {"mfu": 100.0 * flops / elapsed / counts.PEAK_FLOPS[spec["dtype"]],
             "attention_least_s": sum(counts.attention_least_s(step_counts[kind(s)][1],
                                                               spec["dtype"])
                                      for s in session.trace_steps)}
    if session.prof is not None:
        layer["trace"] = Trace.from_profiler(session.prof)
    return layer
