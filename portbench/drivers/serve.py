"""Serving cells: an open loop of independent users in front of the
program's `GeneratorService`.

The service is built as the program builds it (the configuration's G and
caption-encoder specs, `GeneratorService(CondGan(...))` at the
configuration's batch size and caption length, bf16 as configured) and
given the benchmark's weights, whose BatchNorm statistics are calibrated on
the reference. Requests arrive as a Poisson process at the traffic's fixed
rate: the sequence of gaps and of request sizes is drawn once from the
traffic's own seed, and the run's seed rotates it, picks the captions and
gives each request its z seed. One client thread serves them in arrival order;
latency runs from when a request was due to when `generate` returned its
uint8 array, and a request still open when the window closes counts with
its time so far. With --trace 1 a traced segment of `trace_seconds` more
traffic follows. A sample of the finished requests, drawn from the seed
with the largest among them, is compared with the reference.
"""

import gc
import statistics
import time

import numpy as np
import torch

from portbench import correct, counts, data, weights
from portbench.reference.models import calibrating_batch_norm
from portbench.reference.precision import precision
from portbench.reference.train import build
from portbench.trace import GENERATE, WINDOW, Trace


def schedule(traffic: dict, seed: int, seconds: float):
    """(due times, sizes) of the window's requests: n = rate * seconds
    arrivals, uniform order statistics over the window (a Poisson process
    given its count) and sizes from the mix, both drawn from the traffic's
    seed; the run's seed rotates that sequence to start at another request,
    so that every seed offers the same bursts and the tail they make."""
    n = max(1, int(round(traffic["rate_per_s"] * seconds)))
    pool = np.random.default_rng(traffic["pool_seed"])
    gaps = np.diff(np.concatenate([[0.0], np.sort(pool.uniform(0, seconds, n))]))
    sizes = pool.choice(traffic["sizes"], size=n, p=traffic["probs"])
    k = int(np.random.default_rng(weights.derive(seed, 3)).integers(n))
    return np.cumsum(np.roll(gaps, k)), np.roll(sizes, k)


def reference_modules(spec, device):
    G, _, E = build(spec, len(data.vocabulary()), device, remat=False)
    G.eval()
    E.eval()
    return G, E


def make_weights(spec, seed, device):
    """The benchmark's weights, the generator's BatchNorm statistics taken
    from one calibration batch through the reference's eval path; returns
    (weights, seconds the reference took), since set-up leaves those out."""
    G, E = reference_modules(spec, "meta")
    w = weights.model_weights({"G": G, "E": E}, weights.derive(seed, 1), device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    G, E = reference_modules(spec, device)
    weights.load(G, weights.part(w, "G"))
    weights.load(E, weights.part(w, "E"))
    rng = np.random.default_rng(weights.derive(seed, 4))
    n = spec["serve"]["calibration_batch"]
    ids, lengths = data.tokenize(data.captions(n, rng), spec["serve"]["max_caption_len"])
    z = torch.from_numpy(rng.standard_normal((n, G.latent_size), dtype=np.float32))
    with torch.no_grad(), calibrating_batch_norm():
        G(z.to(device), E(torch.from_numpy(ids).to(device), torch.from_numpy(lengths)))
    state = G.state_dict()
    for name in state:
        if name.endswith(("running_mean", "running_var")):
            w[f"G.{name}"] = state[name].clone()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    reference_s = time.perf_counter() - t
    del G, E
    return w, reference_s


def build_service(spec, w, device):
    from txt2vid_tpu_torch.config import create_object
    from txt2vid_tpu_torch.data.vocab import Vocab
    from txt2vid_tpu_torch.gan.cond_gan import CondGan
    from txt2vid_tpu_torch.serve import GeneratorService
    s = spec["serve"]
    vocab = Vocab()
    for word in data.vocabulary():
        vocab.add_word(word)
    txt = create_object(spec["sent"], vocab_size=len(vocab))
    gen = create_object(spec["G"], cond_dim=txt.encoding_size,
                        **({"dtype": torch.bfloat16} if s["bf16"] else {}))
    svc = GeneratorService(CondGan(gen, txt), vocab=vocab, batch_size=s["batch_size"],
                           max_caption_len=s["max_caption_len"], device=device)
    weights.load(gen, weights.part(w, "G"))
    weights.load(txt, weights.part(w, "E"))
    return svc


def reference_videos(spec, w, requests, device, name="f32"):
    """The reference's uint8 videos of each (captions, z seed) request: the
    z of chunk c drawn as the service documents it, from a generator on the
    device seeded by SeedSequence([z seed, c])."""
    s = spec["serve"]
    b = s["batch_size"]
    G, E = reference_modules(spec, device)
    weights.load(G, weights.part(w, "G"))
    weights.load(E, weights.part(w, "E"))
    out = []
    with torch.no_grad(), precision(name):
        for caps, zseed in requests:
            ids, lengths = data.tokenize(caps, s["max_caption_len"])
            videos = []
            for c in range(0, len(caps), b):
                gen = torch.Generator(device=device)
                gen.manual_seed(int(np.random.SeedSequence([zseed, c // b])
                                    .generate_state(1)[0]))
                z = torch.randn(b, G.latent_size, generator=gen, device=device)
                rows = slice(c, c + b)
                n = len(caps[rows])
                cond = E(torch.from_numpy(ids[rows]).to(device), torch.from_numpy(lengths[rows]))
                v = G(z[:n], cond)[-1]
                videos.append(((v + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy())
            out.append(np.concatenate(videos))
    return out


class Client:
    """The open loop over a schedule, with what the readers need."""

    def __init__(self, svc, seed, fault=None):
        self.svc, self.seed, self.fault = svc, seed, fault
        self.rng = np.random.default_rng(weights.derive(seed, 5))

    def request(self, index):
        caps = data.captions(int(self.sizes[index]), self.rng)
        return caps, weights.derive(self.seed, 6, index) % 2 ** 32

    def serve(self, due, sizes, start, end, keep=()):
        """Serve the requests due before `end` (seconds after `start`);
        returns (latencies, service times, kept outputs, count finished)."""
        from torch.profiler import record_function
        self.sizes = sizes
        lat, service, kept, done = [], [], {}, 0
        for i, t_due in enumerate(due):
            if t_due >= end - start:
                break
            now = time.perf_counter() - start
            if now >= end - start:
                lat.append(1e3 * (now - t_due))
                continue
            if t_due > now:
                time.sleep(t_due - now)
            caps, zseed = self.request(i)
            t = time.perf_counter()
            with record_function(GENERATE):
                video = self.svc.generate(sentences=caps, seed=zseed)
            t_end = time.perf_counter()
            if self.fault == "altered" and len(video) > 1:
                video = video[::-1].copy()
            service.append(1e3 * (t_end - t))
            lat.append(1e3 * (t_end - start - t_due))
            done += 1
            if i in keep:
                kept[i] = (caps, zseed, video)
        return lat, service, kept, done


def run(spec, traffic, seed, seconds, trace, device, fault=None, control=None,
        window=True, process_start=None):
    """One run of a serving cell (the same dict as the training driver's)."""
    process_start = process_start or time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    w, reference_s = make_weights(spec, seed, device)
    svc = build_service(spec, w, device)
    warm = np.random.default_rng(0)
    for n in sorted(set(traffic["sizes"])):
        svc.generate(sentences=data.captions(int(n), warm), seed=0)
    seconds = seconds if window else traffic["check_seconds"]
    due, sizes = schedule(traffic, seed, seconds)
    client = Client(svc, seed, fault)
    # the sample to compare: drawn from the seed among the requests due in
    # the window's first half, with the largest of them
    first = np.nonzero(due < seconds / 2)[0]
    pick = np.random.default_rng(weights.derive(seed, 7))
    keep = set(pick.choice(first, size=min(traffic["check_requests"], len(first)),
                           replace=False).tolist())
    keep.add(int(first[np.argmax(sizes[first])]))
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    setup_s = start - process_start - reference_s
    lat, service, kept, done = client.serve(due, sizes, start, start + seconds, keep)
    elapsed = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    out = {"attempted": len(lat), "failed": 0, "peak_bytes": peak}
    out["e2e"] = {"serve_p95_ms": float(np.percentile(lat, 95)), "setup_s": setup_s,
                  "peak_mem_gib": (peak or 0) / 2 ** 30}
    layer = {"window_s": elapsed, "requests": len(lat), "finished": done,
             "serve_service_ms": statistics.median(service) if service else None}
    if trace:
        layer.update(_traced(spec, traffic, client, seed, device, service, sizes, done))
        out["trace"] = layer.get("trace")
    out["layer"] = layer
    missing = [i for i in keep if i not in kept]
    del svc, client.svc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    order = sorted(kept)
    prog = [kept[i][2] for i in order]
    reqs = [kept[i][:2] for i in order]
    ref = reference_videos(spec, w, reqs, device)
    checks = correct.serve_checks(prog, ref)
    checks["sampled_requests_unfinished"] = (float(len(missing)), "sampled requests not served")
    out["checks"] = checks
    if control:
        low = reference_videos(spec, w, reqs, device, control)
        out["control_checks"] = correct.serve_checks(low, ref)
    return out


def _traced(spec, traffic, client, seed, device, service, sizes, done):
    """A traced segment of trace_seconds more traffic, and the numbers the
    serving readers take from the window and from it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    s = spec["serve"]
    flops, calls = counts.serve_chunk_counts(spec, len(data.vocabulary()), s["batch_size"],
                                             s["max_caption_len"])
    videos = int(np.sum(sizes[:done]))
    layer = {"mfu": 100.0 * flops / s["batch_size"] * videos / (1e-3 * sum(service))
             / counts.PEAK_FLOPS[spec["dtype"]]}
    due, tsizes = schedule(traffic, seed + 1, traffic["trace_seconds"])
    cuda = torch.device(device).type == "cuda"
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    with record_function(WINDOW):
        start = time.perf_counter()
        _, _, _, n = client.serve(due, tsizes, start, start + traffic["trace_seconds"])
        if cuda:
            torch.cuda.synchronize(device)
    prof.stop()
    chunks = sum(-(-int(k) // s["batch_size"]) for k in tsizes[:n])
    layer["attention_least_s"] = chunks * counts.attention_least_s(calls, spec["dtype"])
    layer["trace"] = Trace.from_profiler(prof)
    return layer
