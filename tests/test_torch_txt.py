"""The port's caption decoder and sentence-encoder pretraining
(txt2vid_tpu_torch/models/txt.py, train/txt.py) against the JAX package's
Seq2Seq.decode and train/txt.py on the CPU, tiny sizes.

Tolerances: decoder logits 1e-5 of their scale and the same symbols; one
train step's loss 1e-5 relative, the Adam moments 1e-5 of their leaf's
scale and the parameters 1e-6 (their change is lr times a ratio of the
moments); the whole CLI against the JAX CLI from the same initial
parameters, 3 iterations, 1e-5 of each leaf's scale.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from test_torch_models import jax_variables
from txt2vid_tpu.data import build_vocab as jax_build_vocab
from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
from txt2vid_tpu.train import txt as jax_txt
from txt2vid_tpu.utils import checkpoint as jax_checkpoint
from txt2vid_tpu_torch.convert import (jax_to_torch_encoder, load_encoder_vars,
                                       torch_to_jax_encoder)
from txt2vid_tpu_torch.data.synthetic import moving_digit_captions
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.train import txt as port_txt
from txt2vid_tpu_torch.utils import checkpoint

VOCAB = 12
ENC = dict(embed_size=8, hidden_size=16, num_layers=2)
SPEC = {"class": "txt2vid_tpu.models.txt.Seq2Seq",
        "args": {"embed_size": 8, "hidden_size": 16, "num_layers": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tokens(seed=0, b=3, length=7):
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, VOCAB, (b, length)).astype(np.int32)
    lens = np.array([length, 3, 5, length - 1][:b], np.int32)
    for i, n in enumerate(lens):
        caps[i, n:] = 0
    return caps, lens


def pair(separate_decoder=False, seed=4):
    """JAX Seq2Seq variables (a full init: encoder and decoder) and the port's
    Seq2Seq holding them."""
    caps, lens = tokens()
    enc = JaxSeq2Seq(vocab_size=VOCAB, separate_decoder=separate_decoder, **ENC)
    variables = jax_variables(enc, seed, jnp.asarray(caps), lengths=jnp.asarray(lens))
    port = Seq2Seq(VOCAB, separate_decoder=separate_decoder, **ENC)
    port.load_state_dict(jax_to_torch_encoder(variables["params"]))
    return enc, variables, port


def scaled_err(ref, got):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(ref - np.asarray(got, np.float64)).max()) / max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("teacher_force", [False, True], ids=["greedy", "teacher"])
@pytest.mark.parametrize("separate_decoder", [False, True], ids=["shared", "separate"])
def test_decode_matches_jax(separate_decoder, teacher_force):
    """Seq2Seq.decode's logits and symbols: the shared decoder from the
    encoder's whole per-layer state, the separate (unidirectional) one from
    zeros; more steps than tokens, so teacher forcing reads past the end."""
    enc, variables, port = pair(separate_decoder)
    caps, lens = tokens(1)
    kw = dict(max_seq_len=9, teacher_force=teacher_force)
    if separate_decoder:
        ref_raw, ref_syms = enc.apply(variables, jnp.asarray(caps), method=enc.decode, **kw)
        got_raw, got_syms = port.decode(torch.as_tensor(caps).long(), **kw)
    else:
        _, states, _ = enc.apply(variables, jnp.asarray(caps), lengths=jnp.asarray(lens),
                                 method=enc.encode)
        ref_raw, ref_syms = enc.apply(variables, jnp.asarray(caps), initial_hidden=states,
                                      method=enc.decode, **kw)
        with torch.no_grad():
            _, state, _ = port.encode(torch.as_tensor(caps).long(), lens)
            got_raw, got_syms = port.decode(torch.as_tensor(caps).long(),
                                            initial_hidden=state, **kw)
    assert got_raw.shape == (3, 9, VOCAB)
    assert scaled_err(ref_raw, got_raw.detach().numpy()) <= 1e-5
    np.testing.assert_array_equal(np.asarray(ref_syms), got_syms.numpy())


def test_teacher_forcing_lags_the_target_by_one():
    """Step t + 1's input is true_inputs[:, min(t, L - 1)]: token 0 twice,
    then tokens 1, 2, ... (txt.py:117-118), step by step through _step."""
    _, _, port = pair()
    caps, lens = tokens(2)
    x = torch.as_tensor(caps).long()
    with torch.no_grad():
        _, state, _ = port.encode(x, lens)
        raw, _ = port.decode(x, initial_hidden=state, max_seq_len=9, teacher_force=True)
        feed = [0, 0, 1, 2, 3, 4, 5, 6, 6]
        s = state
        for t, j in enumerate(feed):
            logits, s = port.encoder._step(x[:, j], s)
            torch.testing.assert_close(raw[:, t], logits, rtol=0, atol=0)


def test_separate_decoder_from_the_encoder_state_raises_in_both():
    """The unidirectional decoder's carry has hidden_size units and the
    encoder's forward carry hidden_size / 2: JAX's decode raises on the
    shapes and so does the port's."""
    enc, variables, port = pair(separate_decoder=True)
    caps, lens = tokens()
    _, states, _ = enc.apply(variables, jnp.asarray(caps), lengths=jnp.asarray(lens),
                             method=enc.encode)
    with pytest.raises(Exception, match="shape"):
        enc.apply(variables, jnp.asarray(caps), initial_hidden=states, method=enc.decode,
                  max_seq_len=2)
    with torch.no_grad():
        _, state, _ = port.encode(torch.as_tensor(caps).long(), lens)
        with pytest.raises(RuntimeError, match="hidden"):
            port.decode(torch.as_tensor(caps).long(), initial_hidden=state, max_seq_len=2)


@pytest.mark.parametrize("separate_decoder", [False, True], ids=["shared", "separate"])
def test_encoder_tree_round_trips(separate_decoder):
    _, variables, port = pair(separate_decoder)
    tree = torch_to_jax_encoder(port.state_dict())
    ref = jax.tree_util.tree_map(np.asarray, variables["params"])
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b.numpy())
    enc_only = torch_to_jax_encoder(port.state_dict(), decoder=False)
    assert set(enc_only) == {"encoder"} and "to_vocab" not in enc_only["encoder"]


def test_an_encoder_only_tree_keeps_the_decoder():
    """A tree without to_vocab (the JAX encoder's encode-only init) loads
    into the encoder and leaves the decoder's projection as it was."""
    _, variables, port = pair()
    before = port.encoder.to_vocab.weight.detach().clone()
    params = {"encoder": {k: v for k, v in variables["params"]["encoder"].items()
                          if k != "to_vocab"}}
    with torch.no_grad():
        port.encoder.to_vocab.weight.mul_(2.0)
        load_encoder_vars(port, {"params": params})
    torch.testing.assert_close(port.encoder.to_vocab.weight, 2.0 * before, rtol=0, atol=0)


def test_a_tree_missing_more_than_to_vocab_raises():
    """Only to_vocab may be absent: a tree without the embedding, or the
    model's own state dict loaded strictly without to_vocab, raises."""
    _, variables, port = pair()
    params = {"encoder": {k: v for k, v in variables["params"]["encoder"].items()
                          if k not in ("to_vocab", "embed")}}
    with pytest.raises(KeyError, match="embed"), torch.no_grad():
        load_encoder_vars(port, {"params": params})
    sd = {k: v for k, v in port.state_dict().items() if ".to_vocab." not in k}
    with pytest.raises(RuntimeError, match="to_vocab"):
        port.load_state_dict(sd)


def jax_step(model, max_len, teacher_force, lr):
    loss_fn = jax_txt.build_loss_fn(model, max_len)
    opt = optax.adam(lr)

    def step(params, opt_state, caps, lengths):
        loss, grads = jax.value_and_grad(
            lambda p: loss_fn(p, caps, lengths, teacher_force))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss
    return opt, jax.jit(step)


@pytest.mark.parametrize("teacher_force", [False, True], ids=["free", "teacher"])
def test_one_train_step_matches_jax(teacher_force):
    """One train.txt step (masked next-token NLL, optax's default Adam) from
    the same parameters and batch: loss, moments and parameters."""
    caps, lens = tokens(3, b=4, length=8)
    enc, variables, port = pair(seed=6)
    lr = 1e-3
    opt, step = jax_step(enc, 8, teacher_force, lr)
    params, opt_state, ref_loss = step(variables["params"], opt.init(variables["params"]),
                                       jnp.asarray(caps), jnp.asarray(lens))
    popt = torch.optim.Adam(port_txt.trainable(port), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    loss = port_txt.make_step(port, popt)(torch.as_tensor(caps).long(),
                                          torch.as_tensor(lens).long(), teacher_force)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    from txt2vid_tpu_torch.convert import txt_state_to_jax
    got = checkpoint.to_host(txt_state_to_jax(port, popt))
    ref = {"optim": serialization.to_state_dict(opt_state),
           "txt": {"params": jax.tree_util.tree_map(np.asarray, params)}}
    assert int(got["optim"]["0"]["count"]) == int(ref["optim"]["0"]["count"]) == 1
    for key, tol in (("mu", 1e-5), ("nu", 1e-5)):
        for a, b in zip(jax.tree_util.tree_leaves(ref["optim"]["0"][key]),
                        jax.tree_util.tree_leaves(got["optim"]["0"][key])):
            scale = max(float(np.abs(a).max()), 1e-30)
            assert float(np.abs(np.asarray(a) - b).max()) <= tol * scale, key
    for a, b in zip(jax.tree_util.tree_leaves(ref["txt"]), jax.tree_util.tree_leaves(got["txt"])):
        assert float(np.abs(np.asarray(a) - b).max()) <= 1e-6


@pytest.fixture(scope="module")
def sentences(tmp_path_factory):
    d = tmp_path_factory.mktemp("sents")
    caps = moving_digit_captions(48, seed=2)
    with open(d / "sent.pickle", "wb") as f:
        pickle.dump({i: [c] for i, c in enumerate(caps)}, f)
    with open(d / "vocab.pickle", "wb") as f:
        pickle.dump(jax_build_vocab(caps), f)
    return d


def cli_argv(d, out, *extra):
    return ["--sentences", str(d / "sent.pickle"), "--vocab", str(d / "vocab.pickle"),
            "--model", json.dumps(SPEC), "--out", str(out), "--batch_size", "12",
            "--max_len", "8", "--lr", "1e-3", "--save_every", "2", "--log_every", "1",
            "--seed", "5", *extra]


def jax_initial_params(d, seed):
    """The parameters the JAX CLI initializes (txt.py:101-105)."""
    from txt2vid_tpu.config import create_object
    from txt2vid_tpu.data import load_pickle
    vocab = load_pickle(str(d / "vocab.pickle"))
    dset = jax_txt.SentenceDataset(vocab, str(d / "sent.pickle"), max_len=8)
    order = np.random.default_rng(seed).permutation(len(dset))
    model = create_object(json.dumps(SPEC), vocab_size=len(vocab))
    caps, lengths = dset.batch(order[:int(0.8 * len(dset))][:12])
    return model.init(jax.random.key(seed), caps, lengths=lengths)


def test_cli_matches_the_jax_cli(sentences, tmp_path, monkeypatch):
    """Both CLIs from the JAX CLI's initial parameters, one epoch (3
    iterations: the seeded split, the per-iteration teacher-force coin,
    validation and checkpoints at 2): the same txt_final within 1e-5 of each
    leaf's scale, each package's file read by the other."""
    jax_txt.cli(cli_argv(sentences, tmp_path / "jax", "--epochs", "1"))
    init = jax_initial_params(sentences, 5)

    def jax_init(model, seed):
        assert seed == 5
        model.load_state_dict(jax_to_torch_encoder(jax.tree_util.tree_map(
            np.asarray, init["params"])))
        return model

    monkeypatch.setattr(port_txt, "init_from_seed", jax_init)
    model, _ = port_txt.cli(cli_argv(sentences, tmp_path / "port", "--epochs", "1",
                                     "--device", "cpu"))
    for name in ("txt_iter_2", "txt_final"):
        assert (tmp_path / "port" / name).exists() and (tmp_path / "jax" / name).exists()
    ref = checkpoint.restore_state(
        checkpoint.to_host(port_txt.txt_state_to_jax(model, torch.optim.Adam(
            port_txt.trainable(model)))), tmp_path / "jax" / "txt_final")
    got = checkpoint.restore_state(ref, tmp_path / "port" / "txt_final")
    assert int(got["optim"]["0"]["count"]) == int(ref["optim"]["0"]["count"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(got)):
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(np.asarray(a, np.float64) - b).max()) <= 1e-5 * scale
    # the port's file through the JAX package's loader, and the JAX file through
    # the port's --sent_weights reader, encode alike
    caps, lens = tokens(4)
    jax_vars = jax_checkpoint.restore_txt_vars(str(tmp_path / "port" / "txt_final"))
    enc = JaxSeq2Seq(vocab_size=model.encoder.embed.num_embeddings, **ENC)
    ref_hn = np.asarray(enc.apply(jax_vars, jnp.asarray(caps), lengths=jnp.asarray(lens),
                                  method=enc.encode)[2])
    port = Seq2Seq(model.encoder.embed.num_embeddings, **ENC)
    with torch.no_grad():
        load_encoder_vars(port, checkpoint.restore_txt_vars(tmp_path / "jax" / "txt_final"))
        got_hn = port.encode(torch.as_tensor(caps).long(), lens)[2].numpy()
    assert scaled_err(ref_hn, got_hn) <= 1e-5


def test_cli_resumes_and_the_loss_falls(sentences, tmp_path):
    """--weights resumes from a txt checkpoint (parameters and Adam state), and
    three epochs lower the training loss."""
    model, opt = port_txt.cli(cli_argv(sentences, tmp_path / "a", "--epochs", "3",
                                       "--device", "cpu", "--lr", "3e-3"))
    lines = [json.loads(x) for x in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    train = [x["value"] for x in lines if x["tag"] == "loss/train"]
    assert len(train) == 9 and all(np.isfinite(train)) and train[-1] < train[0]
    assert sum(x["tag"] == "loss/val" for x in lines) == 4
    saved = (tmp_path / "a" / "txt_final").read_bytes()
    from txt2vid_tpu_torch.utils import msgpack
    assert saved == msgpack.packb(checkpoint.to_host(port_txt.txt_state_to_jax(model, opt)))
    resumed, ropt = port_txt.cli(cli_argv(sentences, tmp_path / "b", "--epochs", "0",
                                          "--device", "cpu", "--weights",
                                          str(tmp_path / "a" / "txt_final")))
    assert (tmp_path / "b" / "txt_final").read_bytes() == saved
