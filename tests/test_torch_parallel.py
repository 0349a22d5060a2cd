"""The port's parallel layer (txt2vid_tpu_torch/parallel, ops/ring_attention.py,
the multi-device flags of train/gan.py) on the CPU: gloo groups of 2 and 4
processes (tests/torch_parallel_worker.py, each spawn under its own
120-second limit, killed and failed past it) against one device.

The step configuration is test_torch_train_step's tiny conditional TGANv2
(32 px, 8 frames, fm 32, Attention(32) in the generator, Attention3d(128)
in the discriminator, here of one DownBlock per scale, a one-layer Bi-LSTM
encoder) with the subsample
pyramid over 3 scales (8/16/32 px, the fewest pixels three scales reach),
RSGAN, the gradient penalty (0.5) and --clip_grad 1e-3 (below every norm,
so both phases clip). The JAX package's single-device step runs with its
plain attention (use_pallas=False), jitted once per configuration; its
draws (z from its key split, the pyramid's and the generator's phases, the
derangement and the GP weights recorded by wrapping subsample_video,
gen_perm_device and _interpolate) are the global draws every rank is given.

- dp=2 at batch 6 (3 per rank: the first subsample splits the global
  x[::2] 2 / 1) and batch 4 (2 per rank: rank 1 holds zero items at the
  last scale), then RaSGAN, --end2end and attn_b6 at batch 6, each against JAX's
  step: losses 1e-4 relative (measured up to 2.5e-6), grad norms 1e-3
  relative (measured up to 1.4e-4, G's), D's Adam first moments 1e-3 of the
  leaf scale (measured up to 2.6e-4; the port's one-process step sits up
  to 2.2e-4 from JAX's there: the GP's double backward, as in
  test_torch_gp_step.py); and against the port's one-process step: losses
  1e-5 relative (measured 5.2e-7), norms 1e-4 (2.3e-6), D's first moments
  1e-3 of the leaf scale (2.6e-4, at the stem convolutions' biases, which
  feed a BatchNorm), G's 3e-3 (5.9e-4). BatchNorm over the group forms
  flax's one-pass E[x^2] - E[x]^2, one device the two-pass variance, and the
  tiny generator's first BatchNorm amplifies such rounding in G's gradients
  (test_torch_end2end.py), so G is held to JAX only through its loss and
  norm. Both ranks end bit for bit equal.
- fsdp=2 against the port's replicated step, bit for bit; each rank holds
  half of every leaf fsdp_spec splits.
- dp=2 x sp=2 (4 ranks: ring attention in G and D), remat off and on in
  both (each recomputation runs BatchNorm over the dp group and attention
  over the ring), against the port's one-process step from the port's init
  with every gamma 0.5, as dp, and against JAX's single-device step of the
  case attn_b6 (batch 6, RSGAN, every gamma 0.5, so the attention's
  gradients reach the losses) at the dp tolerances (measured: losses
  1.9e-6, norms 6.4e-6, D's first moments 1.3e-4 of the leaf scale); all
  four ranks end bit for bit equal.
- ring attention at sp=2 and sp=4 against JAX's ring_attention on the
  conftest's virtual CPU devices and against the plain attention: outputs
  and the three gradients within 2e-5 (tests/test_ring_attention.py:31).
- the training CLI: two processes with --multihost against each other
  (rank-0-only checkpoints that the JAX package restores, --resume), fsdp=2
  under torchrun's environment against one process (rank 0's checkpoint
  byte for byte), the refusals; --device_data and --steps_per_dispatch
  across ranks are tests/test_torch_parallel_levers.py's.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from txt2vid_tpu_torch.parallel import fsdp_spec

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
SPAWN_TIMEOUT = 120

GEN = dict(latent_size=8, width=32, height=32, fm_channels=32, additional_blocks=(32, 16),
           num_frames=8, cond_dim=16)
DISC = dict(discrim_down_blocks=(1, 1, 1), cond_dim=16)
ENC = dict(vocab_size=20, embed_size=8, hidden_size=16, num_layers=1)
FRAME_SIZES = (8, 16, 32)
GP, CLIP = 0.5, 1e-3
# the JAX step's XLA compile at LLVM's lowest optimisation (a third less
# compile time; the step runs in milliseconds)
JAX_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
CASES = {
    "rsgan_b6": dict(batch=6, loss="RSGANLoss"),
    "rsgan_b4": dict(batch=4, loss="RSGANLoss"),
    "rasgan_b6": dict(batch=6, loss="RaSGANLoss"),
    "end2end_b6": dict(batch=6, loss="RSGANLoss", end2end=True),
    # every attention's gamma 0.5, so the attention's gradients reach the
    # loss: the case dp=2 x sp=2 (ring attention in G and D) is held to
    "attn_b6": dict(batch=6, loss="RSGANLoss", gamma=0.5),
}
SP_CASE = "attn_b6"


def needs_jax_package():
    """Skip where the JAX package cannot be imported (the card's machine has
    jax but neither flax nor optax)."""
    for name in ("jax", "flax", "optax"):
        pytest.importorskip(name)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv_of_rank, world, env=None, timeout=SPAWN_TIMEOUT, cwd=ROOT):
    """Start `world` processes (argv_of_rank(r)) with torchrun's environment
    for a gloo group; wait for all within `timeout` seconds, else kill them
    and fail. Returns their outputs; a non-zero exit fails."""
    port = free_port()
    base = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(world), OMP_NUM_THREADS="1", **(env or {}))
    procs = [subprocess.Popen(argv_of_rank(r), cwd=str(cwd), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank of {world} did not finish within {timeout} s")
    failed = [f"rank {r} exited {p.returncode}:\n{out[-3000:]}"
              for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    assert not failed, "\n".join(failed)
    return outs


def run_ranks(jobs, world, tmp):
    """Run `jobs` on `world` gloo ranks; per rank its list of results."""
    path = tmp / "jobs.pkl"
    with open(path, "wb") as f:
        pickle.dump(jobs, f)
    spawn(lambda r: [sys.executable, str(WORKER), str(path), str(tmp)], world)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def make_batch(b, seed=0):
    rng = np.random.default_rng(seed)
    video = rng.uniform(-1, 1, (b, 8, 32, 32, 3)).astype(np.float32)
    caps = rng.integers(1, ENC["vocab_size"], (b, 6)).astype(np.int32)
    lens = rng.integers(2, 7, b).astype(np.int32)
    for i, n in enumerate(lens):
        caps[i, n:] = 0
    return {"video": video, "captions": caps, "lengths": lens}


def port_config(end2end=False, **extra):
    return dict(frame_sizes=FRAME_SIZES, subsample_input=True, latent_size=GEN["latent_size"],
                shared_gen_fwd=True, gp_lambda=GP, clip_grad=CLIP, end2end=end2end, **extra)


def step_job(state, batch, draws, loss="RSGANLoss", mesh=None, end2end=False, remat=False):
    return dict(kind="step", gen=dict(GEN, remat=remat), disc=dict(DISC, remat=remat), enc=ENC,
                config=port_config(end2end), loss=loss, state=str(state), batch=batch,
                draws=draws, mesh=mesh or {})


def one_process_step(job):
    """The port's step on one process (no mesh) from the job's state, batch
    and draws: (metrics, the state as the JAX tree)."""
    from torch_parallel_worker import batch_of, build_step, draws_of
    from txt2vid_tpu_torch.convert import torch_state_to_jax
    from txt2vid_tpu_torch.utils.checkpoint import to_host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        step = build_step(job)
        metrics = step(batch_of(job["batch"]), draws_of(job["draws"]))
    finally:
        torch.set_num_threads(n)
    return {k: float(v) for k, v in metrics.items()}, to_host(torch_state_to_jax(step))


def flat(tree, prefix=""):
    """A state tree (dicts, tuples, namedtuples) as {path: numpy array}."""
    if tree is None:
        return {}
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def first_moments(tree, side):
    """{leaf path: Adam mu} of one side ("g" or "d") of a state tree."""
    opt = tree["opt_g_state" if side == "g" else "opt_d_state"] if isinstance(tree, dict) \
        else getattr(tree, "opt_g_state" if side == "g" else "opt_d_state")
    mu = opt["0"]["mu"] if isinstance(opt, dict) else opt[0].mu
    return flat(mu)


def check_moments(ref, got, tol, what):
    """Each leaf within tol of its scale (max|ref| floored at 1e-2 of the
    largest leaf); null leaves (below 1e-5 of the largest) hold noise there."""
    assert set(ref) == set(got), what
    top = max(float(np.abs(v).max()) for v in ref.values())
    worst = {}
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-2 * top)
        if float(np.abs(r).max()) < 1e-5 * top:
            assert float(np.abs(got[k]).max()) < 1e-5 * top, f"{what} {k} is not null"
            continue
        worst[k] = float(np.abs(r - got[k]).max()) / scale
    top_leaf = max(worst, key=worst.get)
    print(f"{what}: first moments {worst[top_leaf]:.3g} of the leaf scale at {top_leaf} "
          f"(tol {tol})")
    assert worst[top_leaf] <= tol, (what, sorted(worst.items(), key=lambda kv: -kv[1])[:3])


def check_metrics(ref, got, tol, what, norm_tol=None):
    print(f"{what}: relative differences " + ", ".join(
        f"{k} {abs(got[k] - ref[k]) / abs(ref[k]):.3g}" for k in ref))
    for k in ("loss_d", "loss_g"):
        assert np.isfinite(got[k]) and abs(got[k] - ref[k]) <= tol * abs(ref[k]), \
            (what, k, ref[k], got[k])
    for k in ("grad_norm_d", "grad_norm_g"):
        assert abs(got[k] - ref[k]) <= (norm_tol or tol) * abs(ref[k]), \
            (what, k, ref[k], got[k])




def port_state(path, seed=0):
    """A train-state file of the tiny models from the port's own init (the
    port-only cases, which also run where JAX is not installed)."""
    from txt2vid_tpu_torch.convert import torch_state_to_jax
    from txt2vid_tpu_torch.gan import losses as port_losses
    from txt2vid_tpu_torch.gan.cond_gan import CondGan
    from txt2vid_tpu_torch.gan.train_step import (TrainConfig, adam, build_train_step,
                                                  optimizer_params)
    from txt2vid_tpu_torch.models import tganv2
    from txt2vid_tpu_torch.models.txt import Seq2Seq
    from txt2vid_tpu_torch.ops.initializers import init_from_seed
    from txt2vid_tpu_torch.utils.checkpoint import save_state
    gen = tganv2.MultiScaleGen(**GEN, with_non_local=True)
    disc = tganv2.MultiScaleDiscrim(**DISC)
    enc = Seq2Seq(**ENC)
    for k, m in enumerate((gen, disc, enc)):
        init_from_seed(m, seed + k)
    with torch.no_grad():           # nonzero gammas: the attention gradients flow
        for n, p in [*gen.named_parameters(), *disc.named_parameters()]:
            if n.endswith("gamma"):
                p.fill_(0.5)
    gan = CondGan(gen, enc, discrims=[disc])
    cfg = TrainConfig(**port_config())
    g_params, d_params = optimizer_params(gan, cfg)
    step = build_train_step(gan, port_losses.RSGANLoss(), adam(g_params), adam(d_params), cfg)
    save_state(torch_state_to_jax(step), path)
    d = step.draw(6, "cpu")
    return dict(z=d.z.numpy(), pyramid=list(d.pyramid_phases), gen=list(d.gen_phases),
                perm=d.perms[0].numpy(), alphas=[a.numpy() for a in d.alphas[0]])


def ring_inputs(seed, b=2, n=16, m=8, d=4, dv=16):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in
            (("theta", (b, n, d)), ("phi", (b, m, d)), ("g", (b, m, dv)), ("do", (b, n, dv)))}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port against itself, no JAX: fsdp=2 and ring sp=2 on 2 ranks,
    dp=2 x sp=2 (remat off and on in G and D) and ring sp=4 on 4 ranks, and
    the one-process step."""
    tmp = tmp_path_factory.mktemp("port")
    draws = port_state(tmp / "state")
    job = step_job(tmp / "state", make_batch(6, seed=1), draws)
    rings = {2: ring_inputs(2), 4: ring_inputs(4)}
    two = run_ranks([dict(job, mesh={"fsdp": 2}), dict(kind="ring", sp=2, **rings[2])], 2,
                    tmp_path_factory.mktemp("two"))
    remat = step_job(tmp / "state", make_batch(6, seed=1), draws, remat=True)
    four = run_ranks([dict(job, mesh={"sp": 2}), dict(kind="ring", sp=4, **rings[4]),
                      dict(remat, mesh={"sp": 2})], 4, tmp_path_factory.mktemp("four"))
    return dict(job=job, one=one_process_step(job), fsdp=[r[0] for r in two],
                dp_sp=[r[0] for r in four], dp_sp_remat=[r[2] for r in four], rings=rings,
                ring={2: [r[1] for r in two], 4: [r[1] for r in four]})


def test_fsdp2_equals_the_replicated_step_bit_for_bit(port_runs):
    one_metrics, one_state = port_runs["one"]
    ref = flat(one_state)
    for r in port_runs["fsdp"]:
        assert r["collectives"]["gloo/all_gather"] > 0
        assert r["metrics"] == one_metrics
        got = flat(r["state"])
        assert ref.keys() == got.keys()
        bad = [k for k in ref if not np.array_equal(ref[k], got[k])]
        assert not bad, bad[:5]


def test_fsdp2_ranks_hold_half_of_each_sharded_leaf(port_runs):
    from txt2vid_tpu_torch.models import tganv2
    full = {f"{i}.{n}": tuple(p.shape) for i, m in enumerate(
        [tganv2.MultiScaleGen(**GEN, with_non_local=True), tganv2.MultiScaleDiscrim(**DISC)])
        for n, p in m.named_parameters()}
    sharded = 0
    for r, rank in enumerate(port_runs["fsdp"]):
        assert rank["coords"] == (0, 0, r)
        for name, shape in full.items():
            dim, want = fsdp_spec(shape, 2), list(shape)
            if dim is not None:
                want[dim] //= 2
                sharded += 1
            assert rank["at_rest"][name] == tuple(want), name
    assert sharded > 0


def check_dp2_sp2(ref, ranks, what, tol, norm_tol, g_tol=None):
    """The 4 ranks of a dp=2 x sp=2 step against a one-device step `ref`
    (metrics, state): the mesh, the ring's rotations, the metrics, D's (and
    with g_tol G's) first moments, and every rank's state the same."""
    ref_metrics, ref_state = ref
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    assert [r["local_batch"] for r in ranks] == [3] * 4
    # the ring ran: its key/value rotations are the only send/recv
    assert all(r["collectives"].get("gloo/send_recv", 0) > 0 for r in ranks)
    for r in ranks:
        check_metrics(ref_metrics, r["metrics"], tol, what, norm_tol=norm_tol)
    check_moments(first_moments(ref_state, "d"), first_moments(ranks[0]["state"], "d"), 1e-3,
                  f"{what} D")
    if g_tol is not None:
        check_moments(first_moments(ref_state, "g"), first_moments(ranks[0]["state"], "g"),
                      g_tol, f"{what} G")
    a = flat(ranks[0]["state"])
    for r in ranks[1:]:
        b = flat(r["state"])
        assert all(np.array_equal(a[k], b[k]) for k in a), "the ranks' states differ"


def test_dp2_sp2_step_matches_the_one_process_step(port_runs):
    check_dp2_sp2(port_runs["one"], port_runs["dp_sp"], "dp2 x sp2", 1e-5, 1e-4, g_tol=3e-3)


def test_dp2_sp2_remat_step_matches_the_one_process_step(port_runs):
    """The same step with remat in G and D: each block's recomputation in
    the backward runs BatchNorm over the dp group and attention over the
    ring, as its forward did."""
    check_dp2_sp2(port_runs["one"], port_runs["dp_sp_remat"], "dp2 x sp2 remat", 1e-5, 1e-4,
                  g_tol=3e-3)


def plain_attention(x):
    """softmax(theta phi^T) g and its three gradients, in float64."""
    theta, phi, g = (torch.from_numpy(x[k]).double().requires_grad_()
                     for k in ("theta", "phi", "g"))
    o = torch.softmax(theta @ phi.transpose(1, 2), dim=-1) @ g
    o.backward(torch.from_numpy(x["do"]).double())
    return [o.detach().numpy()] + [t.grad.numpy() for t in (theta, phi, g)]


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_the_plain_attention(port_runs, sp):
    refs = plain_attention(port_runs["rings"][sp])
    for r in port_runs["ring"][sp]:
        for ref, got in zip(refs, [r["o"], *r["grads"]]):
            assert np.abs(ref - got).max() <= 2e-5, np.abs(ref - got).max()


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_jax_ring_attention(port_runs, sp):
    needs_jax_package()
    import jax
    import jax.numpy as jnp
    from txt2vid_tpu.ops.ring_attention import ring_attention as jax_ring
    from txt2vid_tpu.parallel.mesh import make_mesh as jax_make_mesh
    x = port_runs["rings"][sp]
    mesh = jax_make_mesh(n_devices=sp, sp=sp)
    args = [jnp.asarray(x[k]) for k in ("theta", "phi", "g")]

    def loss(t, p, g):
        return jnp.sum(jax_ring(t, p, g, mesh, "sp") * x["do"])

    refs = [np.asarray(jax.jit(lambda *a: jax_ring(*a, mesh, "sp"))(*args))] + [
        np.asarray(a) for a in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)]
    local = port_runs["ring"][sp][0]
    for ref, got in zip(refs, [local["o"], *local["grads"]]):
        assert np.abs(ref - got).max() <= 2e-5, np.abs(ref - got).max()


@pytest.mark.parametrize("sp", [2, 4])
def test_the_local_ring_is_the_ranks_ring(port_runs, sp):
    """ring_attention_local (the chip check's loop over the blocks) against
    the ranks' ring, both directions, and against one K1 over all of M."""
    from txt2vid_tpu_torch.ops.fused_attention import fused_attention
    from txt2vid_tpu_torch.ops.ring_attention import ring_attention_local, ring_backward_local
    x = {k: torch.from_numpy(v) for k, v in port_runs["rings"][sp].items()}
    o, o32, lse = ring_attention_local(x["theta"], x["phi"], x["g"], sp)
    grads = ring_backward_local(x["theta"], x["phi"], x["g"], o32, lse, x["do"], sp)
    rank = port_runs["ring"][sp][0]
    for ref, got in zip([rank["o"], *rank["grads"]], [o, *grads]):
        assert np.abs(ref - got.numpy()).max() <= 1e-6
    one, one_lse = fused_attention(x["theta"], x["phi"], x["g"], return_lse=True)
    assert (o - one).abs().max() <= 2e-5 and (lse - one_lse).abs().max() <= 2e-5


# ----------------------------------------------------------------- JAX's step

@pytest.fixture(scope="module")
def jax_base():
    """The tiny models' JAX variables (shared by every case: their shapes
    do not depend on the batch) and the JAX modules, plain attention."""
    needs_jax_package()
    import jax.numpy as jnp
    import optax
    from test_torch_models import jax_variables
    from test_torch_train_step import jax_state
    from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
    from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
    gen = jax_tganv2_cond.MultiScaleGen(**GEN, use_pallas=False)
    disc = jax_tganv2_cond.MultiScaleDiscrim(**DISC, use_pallas=False)
    enc = JaxSeq2Seq(**ENC)
    opt = optax.adam(2e-4, b1=0.5, b2=0.999)
    batch = make_batch(4)
    caps, lens = jnp.asarray(batch["captions"]), jnp.asarray(batch["lengths"])
    state = jax_state(gen, disc, enc, caps, lens, opt, opt)
    return dict(gen=gen, disc=disc, enc=enc, opt=opt,
                state=state.replace(txt_vars=jax_variables(enc, 3, caps, lens)))


def jax_lower(case, base, state_path):
    """JAX's single-device step of a case, traced and lowered (its draws
    recorded as outputs), its initial state written to state_path for the
    port's steps to read. Returns a function that compiles and runs it:
    () -> (the batch, the new state, metrics, the global draws as numpy)."""
    import jax
    import jax.numpy as jnp
    from test_torch_train_step import host
    from txt2vid_tpu.gan import losses as jax_losses
    from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
    from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig
    from txt2vid_tpu.gan.train_step import build_train_step as jax_build_train_step
    from txt2vid_tpu.models import tganv2 as jax_tganv2
    from txt2vid_tpu.ops import subsample as jax_subsample
    from txt2vid_tpu.utils import checkpoint as jax_checkpoint
    from txt2vid_tpu.utils import misc as jax_misc

    spec = CASES[case]
    b, end2end = spec["batch"], spec.get("end2end", False)
    batch, opt, state = make_batch(b), base["opt"], base["state"]
    if "gamma" in spec:
        def gammas(tree):
            return jax.tree_util.tree_map_with_path(
                lambda path, v: jnp.full_like(v, spec["gamma"])
                if getattr(path[-1], "key", None) == "gamma" else v, tree)
        state = state.replace(g_vars=gammas(state.g_vars),
                              d_vars=tuple(gammas(v) for v in state.d_vars))
    g_tree, d_tree = {"g": state.g_vars["params"]}, {"d": (state.d_vars[0]["params"],)}
    if end2end:
        g_tree["txt"] = d_tree["txt"] = state.txt_vars["params"]
    state = host(state.replace(opt_g_state=opt.init(g_tree), opt_d_state=opt.init(d_tree)))
    jax_checkpoint.save_state(state, str(state_path))

    rec = {"pyramid": [], "gen": [], "perm": [], "alpha": []}

    def recording(name, fn, pick, when=lambda *a: True):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if when(*args):
                rec[name].append(pick(out, *args))
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_subsample, "subsample_video",
                   recording("pyramid", jax_subsample.subsample_video, lambda o, *a: o[1]))
        mp.setattr(jax_tganv2, "subsample_video",
                   recording("gen", jax_tganv2.subsample_video, lambda o, *a: o[1]))
        mp.setattr(jax_misc, "gen_perm_device",
                   recording("perm", jax_misc.gen_perm_device, lambda o, *a: o))
        mp.setattr(jax_losses, "_interpolate",
                   recording("alpha", jax_losses._interpolate, lambda o, a, *r: a.reshape(-1),
                             when=lambda a, real, fake: real.ndim == 5))
        gan = JaxCondGan(gen=base["gen"], discrims=[base["disc"]], cond_encoder=base["enc"])
        step = jax_build_train_step(gan, getattr(jax_losses, spec["loss"])(), opt, opt,
                                    JaxTrainConfig(**port_config(end2end)))

        def run(state, batch, key):
            new, metrics = step(state, batch, key)
            return new, metrics, {k: list(v) for k, v in rec.items()}

        key = jax.random.key(5)
        args = (state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        lowered = jax.jit(run).lower(*args)

    def compile_and_run():
        new, metrics, draws = lowered.compile(JAX_COMPILE)(*args)
        k_z = jax.random.split(jax.random.fold_in(key, 0), 5)[0]
        n = len(FRAME_SIZES) - 1
        draws = host(draws)
        assert len(draws["perm"]) == 1 and len(draws["alpha"]) == len(FRAME_SIZES)
        return batch, host(new), {k: float(v) for k, v in host(metrics).items()}, dict(
            z=np.array(jax.random.normal(k_z, (b, GEN["latent_size"]))),
            pyramid=[int(v) for v in draws["pyramid"][:n]],
            gen=[int(v) for v in draws["gen"][:n]],
            perm=np.asarray(draws["perm"][0]).astype(np.int64),
            alphas=[np.asarray(a) for a in draws["alpha"]])

    return compile_and_run


@pytest.fixture(scope="module")
def dp_runs(jax_base, tmp_path_factory):
    """Each case: JAX's step, the port's one-process step and its dp=2 step
    on both ranks; SP_CASE also at dp=2 x sp=2 on 4 ranks, remat off and
    on."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("dp")
    # traced one by one (the recording wrappers are module attributes),
    # compiled side by side
    lowered = [jax_lower(name, jax_base, tmp / f"{name}.state") for name in CASES]
    with ThreadPoolExecutor(len(lowered)) as pool:
        results = list(pool.map(lambda f: f(), lowered))
    cases, jobs = {}, []
    for (name, spec), (batch, new, metrics, draws) in zip(CASES.items(), results):
        job = step_job(tmp / f"{name}.state", batch, draws, spec["loss"],
                       end2end=spec.get("end2end", False))
        cases[name] = dict(jax=(metrics, new), one=one_process_step(job))
        jobs.append(job)
    for name, ranks in zip(CASES, zip(*run_ranks(jobs, 2, tmp))):
        cases[name]["dp"] = list(ranks)
    sp_job = jobs[list(CASES).index(SP_CASE)]
    four = run_ranks([dict(sp_job, mesh={"sp": 2}), dict(sp_job, mesh={"sp": 2},
                                                         gen=dict(GEN, remat=True),
                                                         disc=dict(DISC, remat=True))],
                     4, tmp_path_factory.mktemp("dp_sp"))
    cases[SP_CASE]["dp_sp"] = {False: [r[0] for r in four], True: [r[1] for r in four]}
    return cases


@pytest.mark.parametrize("name", list(CASES))
def test_dp2_step_matches_jax_single_device(dp_runs, name):
    run = dp_runs[name]
    (jax_metrics, jax_new), dp = run["jax"], run["dp"]
    for r in dp:
        check_metrics(jax_metrics, r["metrics"], 1e-4, f"{name} dp2 vs JAX", norm_tol=1e-3)
    check_moments(first_moments(jax_new, "d"), first_moments(dp[0]["state"], "d"), 1e-3,
                  f"{name} D dp2 vs JAX")


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_dp2_sp2_step_matches_jax_single_device(dp_runs, remat):
    """dp=2 x sp=2 (ring attention in G and D, gammas 0.5, the GP's double
    backward on the plain attention), remat off and on in G and D, against
    JAX's single-device step: the dp tolerances."""
    check_dp2_sp2(dp_runs[SP_CASE]["jax"], dp_runs[SP_CASE]["dp_sp"][remat],
                  f"{SP_CASE} dp2 x sp2 {'remat ' if remat else ''}vs JAX", 1e-4, 1e-3)


@pytest.mark.parametrize("name", list(CASES))
def test_dp2_step_matches_the_one_process_step(dp_runs, name):
    run = dp_runs[name]
    (one_metrics, one_state), dp = run["one"], run["dp"]
    assert [r["local_batch"] for r in dp] == [CASES[name]["batch"] // 2] * 2
    for r in dp:
        check_metrics(one_metrics, r["metrics"], 1e-5, f"{name} dp2 vs one process",
                      norm_tol=1e-4)
    check_moments(first_moments(one_state, "d"), first_moments(dp[0]["state"], "d"), 1e-3,
                  f"{name} D")
    check_moments(first_moments(one_state, "g"), first_moments(dp[0]["state"], "g"), 3e-3,
                  f"{name} G")
    check_metrics(run["jax"][0], one_metrics, 1e-4, f"{name} one process vs JAX",
                  norm_tol=1e-3)


@pytest.mark.parametrize("name", list(CASES))
def test_dp2_ranks_end_identical(dp_runs, name):
    a, b = (flat(r["state"]) for r in dp_runs[name]["dp"])
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert dp_runs[name]["dp"][0]["metrics"] == dp_runs[name]["dp"][1]["metrics"]


def test_uneven_and_empty_scales():
    """The global x[::2] per rank: batch 6 on dp=2 splits 2 / 1 at the first
    subsample, batch 4 leaves rank 1 no item at the last scale, and the
    flagship's 40 keeps 3 / 2 at the third; every layout tiles the global
    batch's x[::2] pyramid in rank order."""
    from txt2vid_tpu_torch.parallel import GlobalBatch

    def layouts(b, dp, level):
        return [GlobalBatch(None, r, dp, b // dp).layout(level) for r in range(dp)]

    assert [n for _, n in layouts(6, 2, 1)] == [2, 1]
    assert [n for _, n in layouts(4, 2, 2)] == [1, 0]
    assert [[n for _, n in layouts(40, 2, i)] for i in range(4)] == [
        [20, 20], [10, 10], [5, 5], [3, 2]]
    for b, dp in ((40, 8), (6, 3), (12, 4), (4, 2)):
        glob = np.arange(b)
        for level in range(5):
            got = np.concatenate([glob[off:off + n] for off, n in layouts(b, dp, level)])
            assert np.array_equal(got, glob), (b, dp, level)
            glob = glob[::2]


def test_fsdp_spec_and_sharded_view_match_jax():
    needs_jax_package()
    from txt2vid_tpu.data import ShardedView as JaxShardedView
    from txt2vid_tpu.parallel.mesh import _fsdp_spec
    from txt2vid_tpu_torch.data import ShardedView
    from txt2vid_tpu_torch.models import tganv2_cond
    with torch.device("meta"):
        modules = [tganv2_cond.MultiScaleGen(num_frames=16, cond_dim=256),
                   tganv2_cond.MultiScaleDiscrim(cond_dim=256)]
    shapes = {tuple(t.shape) for m in modules for t in [*m.parameters(), *m.buffers()]}
    assert len(shapes) > 20
    for n in (2, 4, 8):
        for shape in shapes | {(), (4096,), (3, 5, 7, 11)}:
            spec = tuple(_fsdp_spec(shape, n))
            want = spec.index("fsdp") if "fsdp" in spec else None
            assert fsdp_spec(shape, n) == want, (shape, n)

    class Base:
        def __len__(self):
            return 11

        def get_batch(self, idxs, cap=32):
            return {"idxs": np.asarray(idxs), "cap": cap}

    for shards in (1, 2, 3):
        for shard in range(shards):
            ours, theirs = ShardedView(list(range(11)), shard, shards), \
                JaxShardedView(list(range(11)), shard, shards)
            assert len(ours) == len(theirs) and not hasattr(ours, "get_batch")
            assert [ours[i] for i in range(len(ours))] == [theirs[i] for i in range(len(theirs))]
            a, b = ShardedView(Base(), shard, shards), JaxShardedView(Base(), shard, shards)
            assert len(a) == len(b)
            assert a.get_batch([0, 2], 16)["idxs"].tolist() == \
                b.get_batch([0, 2], 16)["idxs"].tolist()


GUARD = r"""
import pickle, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, "tests")
from torch_parallel_worker import batch_of, build_step, draws_of
from txt2vid_tpu_torch.convert import torch_state_to_jax
from txt2vid_tpu_torch.utils.checkpoint import to_host
with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
step = build_step(job)
metrics = step(batch_of(job["batch"]), draws_of(job["draws"]))
assert not [m for m in sys.modules if m.startswith("txt2vid_tpu_torch.parallel")]
with open(sys.argv[2], "wb") as f:
    pickle.dump(({k: float(v) for k, v in metrics.items()}, to_host(torch_state_to_jax(step))), f)
"""


def test_without_a_group_the_step_is_the_one_without_the_parallel_layer(port_runs, tmp_path):
    """With no process group, BatchNorm, the losses, the subsamples,
    attention_core_auto and the step take the one-device path: a step in a
    process that never imports txt2vid_tpu_torch.parallel equals, bit for
    bit, the same step here, where it is imported."""
    with open(tmp_path / "job.pkl", "wb") as f:
        pickle.dump(port_runs["job"], f)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    subprocess.run([sys.executable, "-c", GUARD, str(tmp_path / "job.pkl"),
                    str(tmp_path / "out.pkl")], cwd=str(ROOT), env=env, check=True,
                   timeout=SPAWN_TIMEOUT)
    with open(tmp_path / "out.pkl", "rb") as f:
        metrics, state = pickle.load(f)
    assert "txt2vid_tpu_torch.parallel" in sys.modules
    one_metrics, one_state = port_runs["one"]
    assert metrics == one_metrics
    a, b = flat(state), flat(one_state)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------- the training CLI

CLI_G = {"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
         "args": {"latent_size": 16, "width": 16, "height": 16, "fm_channels": 16,
                  "additional_blocks": [8], "num_frames": 4, "use_pallas": False}}
CLI_D = {"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim",
         "args": {"discrim_down_blocks": [1, 1], "num_channels": 3}}
CLI_S = {"class": "txt2vid.models.txt.basic.Seq2Seq",
         "args": {"embed_size": 16, "hidden_size": 16, "num_layers": 1}}


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    from txt2vid_tpu_torch.data import main as vocab_main
    from txt2vid_tpu_torch.data.synthetic import generate_examples
    d = tmp_path_factory.mktemp("synth")
    generate_examples(d / "videos", d / "sent.pickle", num_examples=16, frame_size=(32, 32),
                      num_frames=4, seed=5, num_channels=3)
    vocab_main(type("A", (), {"sents": str(d / "sent.pickle"), "out": str(d / "vocab.pickle")}))
    return d


def cli_argv(data, out, *extra):
    """tests/test_torch_cli.py's command line: tiny tganv2_cond, RSGAN, GP
    every 2nd step, clip 100, EMA; global batch 4, one epoch of 16 clips."""
    import json
    spec = {"class": "txt2vid_tpu.data.my_dataset",
            "args": {"data": str(data / "videos"), "num_frames": 4}}
    return ["-m", "txt2vid_tpu_torch.train.gan", "--device", "cpu",
            "--G", json.dumps(CLI_G), "--D", json.dumps(CLI_D), "--sent", json.dumps(CLI_S),
            "--data", json.dumps(spec), "--anno", str(data / "sent.pickle"),
            "--vocab", str(data / "vocab.pickle"), "--frame_sizes", "8", "16",
            "--subsample_input", "--num_channels", "3",
            "--D_loss", "txt2vid_tpu.gan.losses.RSGANLoss", "--G_lr", "0.0002",
            "--D_lr", "0.0002", "--G_beta2", "0.999", "--D_beta2", "0.999",
            "--gp_lambda", "0.5", "--gp_every", "2", "--clip_grad", "100",
            "--g_ema", "0.999", "--batch_size", "4", "--seed", "3", "--workers", "1",
            "--epochs", "1", "--save_model_period", "2", "--log_period", "1",
            "--save_example_period", "2", "--out", str(out),
            "--out_samples", str(out / "samples"), *extra]


def checkpoints(out):
    return sorted(p.name for p in Path(out).glob("iter_*")) if Path(out).exists() else []


def jax_opens(path):
    """The JAX package's restore_state reads the file into its own tree."""
    needs_jax_package()
    from txt2vid_tpu.utils import checkpoint as jax_checkpoint
    from txt2vid_tpu_torch.utils import msgpack
    with open(path, "rb") as f:
        template = msgpack.unpackb(f.read())
    restored = jax_checkpoint.restore_state(template, str(path))
    assert int(restored["step"]) > 0 and flat(restored).keys() == flat(template).keys()


def test_two_process_multihost_cli(cli_data, tmp_path):
    """--multihost over a tcp:// coordinator (gloo): each process feeds 2 of
    each global batch of 4, both print the same losses, only process 0
    writes checkpoints (the JAX package opens them), in-loop samples are off,
    and --resume continues the numbering."""
    port = free_port()

    def argv(r, out, *extra):
        return [sys.executable, *cli_argv(cli_data, out, "--multihost", "--coordinator",
                                          f"127.0.0.1:{port}", "--num_processes", "2",
                                          "--process_id", str(r), *extra)]

    outs = spawn(lambda r: argv(r, tmp_path / f"out{r}"), 2)
    import re
    for r, text in enumerate(outs):
        assert f"multihost: process {r}/2" in text
        assert "feeds 8 items, 2/4 of each global batch" in text
        assert "multihost: in-loop sample dumps disabled" in text
    lines = [re.findall(r"Iter \d+, Loss_D: [\d.]+ Loss_G: [\d.]+", t) for t in outs]
    assert len(lines[0]) == 4 and lines[0] == lines[1], lines
    assert [c.split("_")[1] for c in checkpoints(tmp_path / "out0")] == ["2", "2", "4", "4"]
    assert checkpoints(tmp_path / "out1") == []
    assert not list((tmp_path / "out0" / "samples").glob("*.png"))
    jax_opens(next(p for p in (tmp_path / "out0").glob("iter_4_*") if p.suffix != ".ema"))
    port = free_port()
    outs = spawn(lambda r: argv(r, tmp_path / "out0", "--resume"), 2)
    assert [int(c.split("_")[1]) for c in checkpoints(tmp_path / "out0")
            if not c.endswith(".ema")] == [2, 4, 6, 8]
    assert all("Auto-resuming from" in t for t in outs)


def test_fsdp2_cli_checkpoints_equal_the_one_process_ones(cli_data, tmp_path):
    """--fsdp 2 under torchrun's environment (two gloo ranks, dp = 1):
    rank 0's checkpoints and EMA files are byte for byte those of the same
    command line on one process, and so are those after --resume (every
    rank reads the file and keeps its shards); rank 1 writes none."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}

    def run(*extra, out="fsdp{r}"):
        one = subprocess.Popen([sys.executable, *cli_argv(cli_data, tmp_path / "one", *extra)],
                               cwd=str(ROOT), env=dict(env, OMP_NUM_THREADS="1"),
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        spawn(lambda r: [sys.executable, *cli_argv(cli_data, tmp_path / out.format(r=r),
                                                   "--fsdp", "2", *extra)], 2)
        text = one.communicate(timeout=SPAWN_TIMEOUT)[0]
        assert one.returncode == 0, text[-3000:]

    run()
    names = checkpoints(tmp_path / "one")
    assert len(names) == 4 and checkpoints(tmp_path / "fsdp0") == names
    assert checkpoints(tmp_path / "fsdp1") == []
    run("--resume", out="fsdp0")
    names = checkpoints(tmp_path / "one")
    assert len(names) == 8 and checkpoints(tmp_path / "fsdp0") == names
    for name in names:
        assert (tmp_path / "one" / name).read_bytes() == (tmp_path / "fsdp0" / name).read_bytes()
    jax_opens(tmp_path / "fsdp0" / next(n for n in names if not n.endswith(".ema")))


def test_refusals(cli_data, tmp_path):
    """The JAX CLI's refusals under --multihost, with its messages; --sp 2 on
    one process names the sizes; --device_data and --steps_per_dispatch 2
    pass the world check at a world size above 1, and --test does not."""
    from txt2vid_tpu_torch.train import gan
    argv = cli_argv(cli_data, tmp_path)[2:]
    for extra, message in (
            (["--test"], "--test sampling is single-process"),
            (["--device_data"], "--device_data + --multihost is not supported"),
            (["--fsdp", "2"], "--fsdp + --multihost checkpointing needs a distributed")):
        with pytest.raises(SystemExit, match=message.replace("+", "\\+")):
            gan.cli(argv + ["--multihost", *extra])
    with pytest.raises(ValueError, match=r"1 devices not divisible by sp=2 \* fsdp=1"):
        gan.cli(argv + ["--sp", "2"])
    with pytest.raises(ValueError, match="--clip_grad_split with fsdp state shardings"):
        gan.cli(argv + ["--fsdp", "2", "--clip_grad_split"])
    for extra in (["--device_data"], ["--steps_per_dispatch", "2"]):
        for world in (1, 2):
            gan.check_world_flags(gan.build_parser().parse_args(argv + extra), world)
    with pytest.raises(SystemExit, match="--test sampling is single-process"):
        gan.check_world_flags(gan.build_parser().parse_args(argv + ["--test"]), 2)
    with pytest.raises(ValueError, match="--device_data implies --steps_per_dispatch 1"):
        gan.cli(argv + ["--device_data", "--steps_per_dispatch", "2"])
