"""The multi-rank cases of the port's parallelism tests, run on every rank
of a gloo world by ``mesh_world.run_world``.

This module imports numpy, torch and the port only (never JAX): each case
takes its inputs pickled from the test (port parameter trees, configs,
numpy arrays) and returns numpy results, which the test holds against the
JAX package in its own process.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from audax_torch.core.config import MeshConfig
from audax_torch.parallel.mesh import make_mesh, use_mesh


def _np(t):
    return t.detach().float().numpy() if t.dtype.is_floating_point \
        else t.detach().numpy()


def _mesh(model: int, data: int = -1):
    return make_mesh(MeshConfig(data=data, model=model), device="cpu")


# ------------------------------------------------------------- mesh.py ----
def mesh_layout(batch: np.ndarray):
    """make_mesh's shapes and errors, the multi-host mesh's groups, and
    each rank's shard_batch block."""
    from audax_torch.parallel.mesh import (axis_rank, batch_rank, batch_size,
                                           init_distributed,
                                           make_multihost_mesh, shard_batch)

    out = {"rank": dist.get_rank()}
    errors = {}
    for name, cfg in (("model3", MeshConfig(model=3)),
                      ("too_big", MeshConfig(data=4, model=2)),
                      ("subset", MeshConfig(data=1, model=2))):
        try:
            make_mesh(cfg, device="cpu")
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    shapes = {}
    for name, cfg in (("default", MeshConfig()),
                      ("model2", MeshConfig(model=2)),
                      ("data2", MeshConfig(data=2, model=2))):
        m = make_mesh(cfg, device="cpu")
        shapes[name] = (tuple(m.mesh_dim_names), tuple(m.shape),
                        axis_rank(m, "data"), axis_rank(m, "model"))
    out["shapes"] = shapes
    m = make_mesh(MeshConfig(model=2), device="cpu")
    out["block"] = shard_batch(m, {"x": batch})["x"].numpy()
    mh = make_multihost_mesh(MeshConfig(model=2), num_hosts=2, device="cpu")
    out["multihost"] = (tuple(mh.mesh_dim_names), tuple(mh.shape),
                        batch_size(mh), batch_rank(mh))
    out["mh_block"] = shard_batch(mh, batch).numpy()
    out["init_noop"] = init_distributed()
    return out


# --------------------------------------------------------------- TP ------
def tp_whisper(params, cfg, mel, tokens, labels, prompt, eos, params_big,
               cfg_big, tok, audio, int8_steps):
    """Whisper under a (data, model) mesh: the forward, its gradients
    (data + tensor parallel, gathered whole), greedy / beam / int8-KV
    decoding, the int4 Transcriber, and ``int8_steps`` fine-tune steps
    with int8 moments (``tp_int8_steps``)."""
    from audax_torch.infer.beam import beam_search
    from audax_torch.infer.decode import generate
    from audax_torch.infer.transcribe import Transcriber
    from audax_torch.models.whisper import (encode, tree_leaves, tree_map,
                                            whisper_forward)
    from audax_torch.parallel.fsdp import Layout
    from audax_torch.parallel.mesh import shard_batch
    from audax_torch.parallel.sharding import shard_params, tp_specs
    from audax_torch.train.seq2seq import seq2seq_loss_sum

    mesh = _mesh(2)
    local = shard_params(params, mesh)
    mel_t, tok_t = torch.from_numpy(mel), torch.from_numpy(tokens)
    out = {}
    with use_mesh(mesh), torch.no_grad():
        out["logits"] = _np(whisper_forward(local, cfg, mel_t, tok_t))
        enc = encode(local, cfg, mel_t)
    out["enc"] = _np(enc)

    # gradients of the summed CE over the global count: this rank's rows,
    # its TP blocks; summed over 'data' by the layout, gathered whole
    lay = Layout(mesh, tp_specs(params, mesh))
    train = tree_map(lambda t: t.clone().requires_grad_(True), local)
    rows = shard_batch(mesh, {"mel": mel_t, "tok": tok_t,
                              "lab": torch.from_numpy(labels)})
    with use_mesh(mesh):
        total, count = seq2seq_loss_sum(
            whisper_forward(train, cfg, rows["mel"], rows["tok"]),
            rows["lab"])
    grads = list(torch.autograd.grad(total, tree_leaves(train)))
    grads, total, count = lay.reduce(grads, total.detach(), count)
    it = iter([g / count for g in grads])
    out["grads"] = tree_map(_np, lay.full(tree_map(lambda _: next(it),
                                                   train)))
    out["loss"] = float(total / count)

    pr = torch.from_numpy(prompt)
    out["greedy"] = _np(generate(local, cfg, enc, pr, max_len=12,
                                 eos_id=eos, mesh=mesh).tokens)
    out["greedy_kvq"] = _np(generate(local, cfg, enc, pr, max_len=12,
                                     eos_id=eos, kv_quant=True,
                                     mesh=mesh).tokens)
    res = beam_search(local, cfg, enc, pr, max_len=12, eos_id=eos,
                      beam_width=3, mesh=mesh)
    out["beam"] = _np(res.tokens)
    out["beam_scores"] = _np(res.scores)

    tr = Transcriber(params_big, cfg_big, tok, max_new_tokens=6,
                     temperature_fallback=False, quantize="int4",
                     mesh=mesh, device="cpu")
    out["int4_text"] = tr.transcribe(audio).text
    tr = Transcriber(params_big, cfg_big, tok, max_new_tokens=6,
                     temperature_fallback=False, beam_width=2, mesh=mesh,
                     device="cpu")
    out["beam_text"] = tr.transcribe(audio).text
    out["int8"] = tp_int8_steps(params, cfg, {
        "mel": mel, "decoder_input_ids": tokens, "labels": labels},
        int8_steps)
    return out


def tp_words(params, cfg, tok, audio, kws):
    """``Transcriber(word_timestamps=True, mesh=)`` over a (1 x 2) mesh,
    the alignment pass on each rank's heads: each ``kws`` entry's text and
    segments with their words (word, start, end, probability)."""
    from audax_torch.infer.transcribe import Transcriber

    mesh = _mesh(2)
    out = {}
    for name, kw in kws.items():
        res = Transcriber(params, cfg, tok, mesh=mesh, device="cpu",
                          **kw).transcribe(audio)
        out[name] = {"text": res.text, "segments": [
            (s.start, s.end, None if s.words is None else
             [(w.word, w.start, w.end, w.probability) for w in s.words])
            for s in res.segments]}
    return out


def tp_int8_steps(params, cfg, batch, steps):
    """Fine-tune steps with int8 moments whole and under TP over the
    world's (data, model 2) mesh: the losses, the TP run's whole trained
    tree, the whole run's, and the q kernel's moment shapes (m whole, v
    cut)."""
    from audax_torch.core.config import FineTuneConfig
    from audax_torch.models.whisper import tree_map
    from audax_torch.parallel.fsdp import shard_state
    from audax_torch.parallel.mesh import shard_batch
    from audax_torch.train.seq2seq import init_finetune, make_finetune_step

    mesh = _mesh(2)
    ft = FineTuneConfig(learning_rate=1e-3, warmup_steps=1, max_steps=10,
                        lora_rank=0, moment_dtype="int8")
    step = make_finetune_step(cfg, remat=False)
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name, st, b in (
            ("whole", init_finetune(params, ft), bt),
            ("tp", shard_state(init_finetune(params, ft), mesh,
                               heads=cfg.heads), shard_batch(mesh, bt))):
        losses = []
        for _ in range(steps):
            st, m = step(st, b)
            losses.append(float(m["loss"]))
        q = st.opt_state.mu["q"]["decoder"]["layers"]["attn"]["q"]["kernel"]
        nu = st.opt_state.nu["decoder"]["layers"]["attn"]["q"]["kernel"]
        out[name] = {"losses": losses, "mu": tuple(q.shape),
                     "nu": tuple(nu.shape),
                     "params": tree_map(_np, st.full_params())}
    return out


def tp_lm(models, tokens, steps, mesh=None):
    """The causal LM under a (1 x 2) mesh: the forward and greedy
    KV-cached decoding of each (params, cfg), cut by
    ``shard_params(..., heads=cfg.heads)``."""
    from audax_torch.models.causal_lm import (embed_tokens, init_lm_cache,
                                              lm_cache_heads, lm_decode_step,
                                              lm_forward)
    from audax_torch.parallel.sharding import CAUSAL_LM_TP_RULES, shard_params

    mesh = mesh or _mesh(2)
    tok_t = torch.from_numpy(tokens)
    out = []
    for params, cfg in models:
        local = shard_params(params, mesh, CAUSAL_LM_TP_RULES,
                             heads=cfg.heads)
        with use_mesh(mesh), torch.no_grad():
            logits = lm_forward(local, cfg, tok_t)
            b = tok_t.shape[0]
            cache = init_lm_cache(cfg, b, steps + 2, device="cpu",
                                  heads=lm_cache_heads(local, cfg))
            cur = tok_t[:, 0]
            seq = []
            for pos in range(steps):
                emb = embed_tokens(local, cur[:, None], torch.float32,
                                   cfg.vocab_size)[:, 0]
                step_logits, cache = lm_decode_step(local, cfg, emb, pos,
                                                    cache)
                cur = step_logits.argmax(-1)
                seq.append(cur)
        out.append({"logits": _np(logits),
                    "greedy": _np(torch.stack(seq, 1)),
                    "k_local": tuple(local["layers"]["k"]["kernel"].shape)})
    return out


# --------------------------------------------------------------- EP ------
def ep_cases(layer, cfg, x, factors, moe_params, moe_cfg, tokens):
    """moe_expert_parallel over a model axis of the world's size at each
    capacity factor, its gradient, and the expert-sharded dense MoE
    forward of a whole model."""
    from audax_torch.models.causal_lm import lm_forward
    from audax_torch.parallel.ep import moe_expert_parallel
    from audax_torch.parallel.sharding import CAUSAL_LM_TP_RULES, shard_params

    mesh = _mesh(dist.get_world_size())
    xt = torch.from_numpy(x)
    out = {}
    with torch.no_grad():
        for cf in factors:
            out[cf] = _np(moe_expert_parallel(layer, cfg, xt, mesh,
                                              capacity_factor=cf))
    xg = xt.clone().requires_grad_(True)
    y = moe_expert_parallel(layer, cfg, xg, mesh)
    (y * y).sum().backward()
    out["x_grad"] = _np(xg.grad)
    with use_mesh(mesh), torch.no_grad():
        out["dense_tp"] = _np(lm_forward(
            shard_params(moe_params, mesh, CAUSAL_LM_TP_RULES), moe_cfg,
            torch.from_numpy(tokens)))
    try:
        q4 = {**layer, "experts": {k: {"kernel_q4": v["kernel"]}
                                   for k, v in layer["experts"].items()}}
        moe_expert_parallel(q4, cfg, xt, mesh)
        out["int4_error"] = None
    except ValueError as e:
        out["int4_error"] = str(e)
    return out


# --------------------------------------------------------- generator -----
def generator_mesh(model, clips, kw, budgets, seed):
    """``ContinuousGenerator(mesh=)`` over a (data, model 2) mesh: the
    greedy results of ``clips`` (slots cut over 'data', the engine's own
    ``CAUSAL_LM_TP_RULES`` cut of the LM over 'model'), then sampled
    tokens at temperature 0.8 with seeds ``seed + i``."""
    from audax_torch.infer.continuous import ContinuousGenerator

    mesh = _mesh(2)
    g = ContinuousGenerator(model, mesh=mesh, device="cpu", **kw)
    for rid, x in clips.items():
        g.submit(rid, x, max_new_tokens=budgets.get(rid))
    out = {"greedy": {r.request_id: (r.tokens, r.avg_logprob)
                      for r in g.run()},
           "local_slots": g.local_slots,
           "lm_q": tuple(g.params["lm"]["layers"]["q"]["kernel"].shape),
           "embed": tuple(g.params["lm"]["embed"].shape),
           "chunks": g.chunks_run}
    g = ContinuousGenerator(model, mesh=mesh, device="cpu",
                            **{**kw, "temperature": 0.8})
    for i, (rid, x) in enumerate(clips.items()):
        g.submit(rid, x, seed=seed + i)
    out["sampled"] = {r.request_id: r.tokens for r in g.run()}
    return out


# -------------------------------------------------------------- FSDP -----
def fsdp_cases(params, cfg, batch, steps, model):
    """Fine-tune steps whole, under DP (x TP) and under FSDP with float32,
    bfloat16 and int8 moments: the losses, the per-rank bytes, the
    moments' dtypes and shapes, the whole trained tree, and the int8 first
    moment (kept whole on every rank)."""
    from audax_torch.core.config import FineTuneConfig
    from audax_torch.models.whisper import tree_leaves, tree_map
    from audax_torch.parallel.fsdp import fsdp_shard_state, shard_state
    from audax_torch.parallel.mesh import shard_batch
    from audax_torch.train.seq2seq import init_finetune, make_finetune_step

    mesh = _mesh(model)
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    local = shard_batch(mesh, bt)
    step = make_finetune_step(cfg, remat=False)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    def run(state, b):
        losses = []
        for _ in range(steps):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return state, losses

    def q_kernel(tree):
        return tree["decoder"]["layers"]["attn"]["q"]["kernel"]

    out = {}
    for moments in ("float32", "bfloat16", "int8"):
        ft = FineTuneConfig(learning_rate=1e-3, warmup_steps=1,
                            max_steps=10, lora_rank=0, moment_dtype=moments)
        whole = init_finetune(params, ft)
        out[f"whole_bytes_{moments}"] = (nbytes(whole.trainable),
                                         nbytes(whole.opt_state.mu))
        whole, out[f"ref_{moments}"] = run(whole, bt)
        if moments == "int8":
            out["whole_params_int8"] = tree_map(_np, whole.trainable)
            out["whole_mu_int8"] = tree_map(_np, whole.opt_state.mu)
        del whole
        st = fsdp_shard_state(init_finetune(params, ft), mesh, min_size=256)
        out[f"bytes_{moments}"] = (nbytes(st.trainable),
                                   nbytes(st.opt_state.mu))
        mu = st.opt_state.mu
        mu = q_kernel(mu["q"] if moments == "int8" else mu)
        nu = q_kernel(st.opt_state.nu)
        out[f"mu_{moments}"] = (str(mu.dtype), tuple(mu.shape))
        out[f"nu_{moments}"] = (str(nu.dtype), tuple(nu.shape))
        st, out[f"fsdp_{moments}"] = run(st, local)
        out[f"params_{moments}"] = tree_map(_np, st.full_params())
        if moments == "int8":
            # the whole int8 first moment, the same bits on every rank
            out["mu_int8_whole"] = tree_map(_np, st.opt_state.mu)
        tp_only = shard_state(init_finetune(params, ft), mesh)
        _, out[f"dp_{moments}"] = run(tp_only, local)
    lora = FineTuneConfig(learning_rate=1e-2, warmup_steps=0, max_steps=10,
                          lora_rank=2)
    g = torch.Generator().manual_seed(0)
    _, out["lora_ref"] = run(init_finetune(params, lora, generator=g), bt)
    g = torch.Generator().manual_seed(0)
    st = fsdp_shard_state(init_finetune(params, lora, generator=g), mesh,
                          min_size=256)
    _, out["lora_fsdp"] = run(st, local)
    return out


# --------------------------------------------------------------- CLI -----
def bench_train_world(params, cfg, tok, runs):
    """``bench-train`` over a mesh of the world's ranks through
    ``cli.main``, ``_load_whisper`` returning (params, cfg, tok): each
    run's (name -> argv) exit code, its JSON line, the losses of its steps
    and the FLOPs ``mfu`` was given."""
    import contextlib
    import io
    import json

    from audax_torch.cli import main as cli
    from audax_torch.train import seq2seq
    from audax_torch.utils import profiling

    cli._load_whisper = lambda *a, **k: (params, cfg, tok)
    real_step, real_mfu = seq2seq.make_finetune_step, profiling.mfu
    seen = {"losses": [], "flops": []}

    def make_step(*a, **k):
        step = real_step(*a, **k)

        def run(state, batch):
            state, m = step(state, batch)
            seen["losses"].append(float(m["loss"]))
            return state, m
        return run

    def mfu(flops, sec, *a, **k):
        seen["flops"].append(flops)
        return real_mfu(flops, sec, *a, **k)

    seq2seq.make_finetune_step = make_step
    profiling.mfu = mfu
    out = {}
    for name, argv in runs.items():
        seen["losses"], seen["flops"] = [], []
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        out[name] = {"rc": rc,
                     "json": json.loads(buf.getvalue().splitlines()[-1]),
                     "losses": list(seen["losses"]),
                     "flops": list(seen["flops"])}
    return out


def cli_world(music, runs, tiny_cfg, env, lora_draw, fit, serve):
    """The command-line and loop cases of one world: ``music`` (argv, run
    dir, env) through ``cli.main``, then each of ``runs`` (argv, run dir)
    with the ``tiny`` Whisper preset cut to ``tiny_cfg``, ``env`` set and
    the LoRA adapters' A drawn as ``lora_draw`` (path -> array, the JAX
    package's draw), every rank in the run's directory (rank 0 writes the
    files), then ``fit_cases(**fit)`` and ``serve_case(**serve)``."""
    from audax_torch.cli import main as cli
    from audax_torch.core.config import WhisperConfig
    from audax_torch.train import seq2seq

    drawn = seq2seq.init_lora

    def init_lora(params, rank, *, targets, generator):
        lora = drawn(params, rank, targets=targets, generator=generator)
        assert set(lora) == set(lora_draw), sorted(lora)
        return {k: {**ab, "a": torch.from_numpy(lora_draw[k]).to(
            ab["a"].device)} for k, ab in lora.items()}

    seq2seq.init_lora = init_lora
    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    codes = []

    def run(argv, run_dir):
        os.makedirs(run_dir, exist_ok=True)
        os.chdir(run_dir)
        codes.append(cli.main(argv))
        dist.barrier()

    argv, run_dir, music_env = music
    os.environ.update(music_env)
    run(argv, run_dir)
    WhisperConfig.tiny = classmethod(lambda cls: tiny_cfg)
    os.environ.update(env)
    for argv, run_dir, *run_env in runs:
        os.environ.update(*run_env)
        run(argv, run_dir)
    return {"codes": codes, "fit": fit_cases(**fit),
            "serve": serve_case(**serve)}


def fit_cases(lm_params, lm_cfg, train_cfg, corpus, model_cls, data,
              eval_data, cls_cfg, two_tower):
    """fit_lm under a (data, model) mesh with and without FSDP,
    fit_classifier data-parallel, and fit_two_tower under the (data,
    model) mesh with and without FSDP (``two_tower``: model, dataset,
    keyword arguments)."""
    from audax_torch.train.lm import fit_lm
    from audax_torch.train.loops import fit_classifier
    from audax_torch.train.two_tower_loop import fit_two_tower

    mesh = _mesh(2)
    out = {}
    for fsdp in (False, True):
        _, hist = fit_lm(lm_params, lm_cfg, train_cfg, corpus, mesh=mesh,
                         fsdp=fsdp, device="cpu")
        out[f"lm_fsdp{int(fsdp)}"] = hist
    dmesh = _mesh(1)
    _, hist = fit_classifier(model_cls, data, eval_data, cls_cfg,
                             mesh=dmesh, device="cpu")
    out["cls"] = {"train_loss": hist["train_loss"],
                  "eval_loss": [e["loss"] for e in hist["eval"]],
                  "eval_acc": [e["accuracy"] for e in hist["eval"]]}
    tt_model, tt_data, tt_kw = two_tower
    for fsdp in (False, True):
        state, hist = fit_two_tower(tt_model, tt_data, mesh=mesh, fsdp=fsdp,
                                    device="cpu", **tt_kw)
        out[f"two_tower_fsdp{int(fsdp)}"] = {
            "history": hist, "step": state.step,
            "adapter_q": _np(state.params["adapter"]["q"]["kernel"])}
    return out


def serve_case(params, cfg, tok, wav_bytes, port_file):
    """``ContinuousBatcher(mesh=)`` behind the HTTP server: rank 0 serves,
    every other rank follows in lockstep; one request's text."""
    import json
    import threading
    import urllib.request

    from audax_torch.cli.http_server import serve_http
    from audax_torch.infer.continuous import ContinuousBatcher, Lockstep
    from audax_torch.parallel.sharding import shard_params

    mesh = _mesh(2)
    cb = Lockstep(ContinuousBatcher(shard_params(params, mesh), cfg, tok,
                                    slots=2, window_seconds=1.0,
                                    max_new_tokens=5, steps_per_sync=4,
                                    mesh=mesh, device="cpu"))
    if dist.get_rank() != 0:
        cb.follow()
        return None
    srv = serve_http(cb, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}"
            "/v1/audio/transcriptions?max_tokens=5", data=wav_bytes,
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            text = json.load(r)["text"]
    finally:
        srv.scheduler.shutdown()
        srv.shutdown()
        srv.scheduler.join()
        cb.stop()
    return text


# --------------------------------------------------------------- SP ------
def _ring_grads(q, k, v, do, axes, ring):
    """Ring (or Ulysses) attention over the 'seq' axis of a mesh of
    ``axes``: each rank's block of the output and of dq/dk/dv, gathered
    over 'seq' in frame order."""
    from audax_torch.parallel.comm import all_gather_cat
    from audax_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                           make_named_mesh)
    from audax_torch.parallel.sp import ring_attention, ulysses_attention

    mesh = make_named_mesh(axes, device="cpu")
    group = axis_group(mesh, "seq")
    n, r = axis_size(mesh, "seq"), axis_rank(mesh, "seq")

    def mine(a):
        s = a.shape[2] // n
        return torch.from_numpy(a[:, :, r * s:(r + 1) * s]).clone()

    ql, kl, vl = (mine(a).requires_grad_(True) for a in (q, k, v))
    attend = ring_attention if ring else ulysses_attention
    o = attend(ql, kl, vl, group=group, scale=q.shape[-1] ** -0.5)
    o.backward(mine(do))
    return {key: _np(all_gather_cat(t, group, 2)) for key, t in
            (("o", o), ("dq", ql.grad), ("dk", kl.grad), ("dv", vl.grad))}


def sp_cases(enc, long, qkv, steps, bad):
    """The sequence-parallel cases of a world of four:
    ``encode_sequence_parallel`` (ring and Ulysses) on (data 2, seq 2) and
    (data 1, model 2, seq 2) meshes and on a long sequence in four blocks;
    ring attention's output and gradients at n_seq 2 and 4; the SP
    fine-tune step on (data 2, seq 2) for each of ``steps`` (name ->
    (state kwargs, FineTuneConfig kwargs, ring)); the indivisible
    sequence's error."""
    from audax_torch.core.config import FineTuneConfig
    from audax_torch.models.bridge import lora_from_numpy
    from audax_torch.models.whisper import tree_map
    from audax_torch.parallel.comm import all_gather_cat
    from audax_torch.parallel.mesh import axis_group, make_named_mesh
    from audax_torch.parallel.sp import (encode_sequence_parallel,
                                         make_sp_finetune_step)
    from audax_torch.train.seq2seq import init_finetune

    out = {}
    ds = make_named_mesh([("data", 2), ("seq", 2)], device="cpu")
    dms = make_named_mesh([("data", 1), ("model", 2), ("seq", 2)],
                          device="cpu")
    params, cfg, mel = enc
    mel = torch.from_numpy(mel)
    with torch.no_grad():
        for ring in (True, False):
            e = encode_sequence_parallel(params, cfg, mel, ds, ring=ring)
            out[("enc", "ds", ring)] = _np(all_gather_cat(
                e, axis_group(ds, "data"), 0))
            out[("enc", "dms", ring)] = _np(encode_sequence_parallel(
                params, cfg, mel, dms, ring=ring))
        params, cfg, mel = long
        s4 = make_named_mesh([("seq", 4)], device="cpu")
        out["long"] = _np(encode_sequence_parallel(
            params, cfg, torch.from_numpy(mel), s4, ring=True))
    for n_seq, axes in ((2, [("data", 2), ("seq", 2)]), (4, [("seq", 4)])):
        for ring in (True, False):
            out[("attn", n_seq, ring)] = _ring_grads(*qkv, axes, ring)
    params, cfg, batch = steps["model"]
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for name, (lora, ft_kw, ring) in steps["runs"].items():
        ft = FineTuneConfig(**ft_kw)
        state = init_finetune(params, ft)
        if lora is not None:
            tr = tree_map(lambda t: t.requires_grad_(True),
                          lora_from_numpy(lora, device="cpu"))
            state = state.replace(trainable=tr, opt_state=state.tx.init(tr))
        state, m = make_sp_finetune_step(cfg, ds, ft, ring=ring)(state,
                                                                  batch)
        out[("step", name)] = (float(m["loss"]),
                               tree_map(_np, state.trainable))
    params, cfg, mel = bad
    try:
        encode_sequence_parallel(params, cfg, torch.from_numpy(mel), ds)
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    return out


# --------------------------------------------------------------- PP ------
def _pp_gather(tree, mesh):
    """A stage-cut tree whole again: every leaf under ``layers``
    all-gathered over 'stage' on its leading axis."""
    from audax_torch.parallel.comm import all_gather_cat
    from audax_torch.parallel.mesh import axis_group
    from audax_torch.parallel.sharding import map_with_path

    group = axis_group(mesh, "stage")
    return map_with_path(
        lambda path, t: _np(all_gather_cat(t, group, 0))
        if "layers" in path.split("/") else _np(t), tree)


def pp_cases(enc, enc_runs, lm, tokens, mask, grad_tokens, train):
    """The pipeline-parallel cases of a world of four: ``encode_pipelined``
    at each (stages, n_micro) of ``enc_runs``; ``lm_forward_pipelined``
    with and without a key-padding mask at 2 and 4 stages; the gradient of
    the mean next-token CE at 2 stages, remat off and on (the layer leaves
    gathered whole); the train step at 4 stages and under PP x DP on
    (stage 2, data 2) (``train``: tokens, steps, learning rate); the
    divisibility errors."""
    from audax_torch.models.whisper import tree_leaves, tree_map
    from audax_torch.parallel.mesh import make_named_mesh
    from audax_torch.parallel.pp import (encode_pipelined,
                                         lm_forward_pipelined,
                                         make_pp_lm_train_step, pp_shard)
    from audax_torch.train.optim import adamw

    meshes = {2: make_named_mesh([("stage", 2), ("data", 2)], device="cpu"),
              4: make_named_mesh([("stage", 4)], device="cpu")}
    out = {}
    params, cfg, mel = enc
    mel = torch.from_numpy(mel)
    with torch.no_grad():
        for stages, n_micro in enc_runs:
            b = 2 * n_micro
            out[("enc", stages, n_micro)] = _np(encode_pipelined(
                params, cfg, mel[:b], meshes[stages], n_micro=n_micro))
        lm_params, lm_cfg = lm
        tok = torch.from_numpy(tokens)
        for stages in (2, 4):
            local = pp_shard(lm_params, meshes[stages])
            out[("lm", stages)] = _np(lm_forward_pipelined(
                local, lm_cfg, tok, meshes[stages], n_micro=2))
            out[("lm_mask", stages)] = _np(lm_forward_pipelined(
                local, lm_cfg, tok, meshes[stages], n_micro=2,
                attention_mask=torch.from_numpy(mask)))
    gt = torch.from_numpy(grad_tokens).long()
    for remat in (False, True):
        local = tree_map(lambda t: t.clone().requires_grad_(True),
                         pp_shard(lm_params, meshes[2]))
        logits = lm_forward_pipelined(local, lm_cfg, gt[:, :-1], meshes[2],
                                      n_micro=2, remat=remat)
        ce = -torch.log_softmax(logits, -1).gather(
            -1, gt[:, 1:, None]).mean()
        grads = torch.autograd.grad(ce, tree_leaves(local))
        it = iter(grads)
        out[("grads", remat)] = _pp_gather(
            tree_map(lambda _: next(it), local), meshes[2])
    dp = make_named_mesh([("stage", 2), ("data", 2)], device="cpu")
    for name, mesh, data_axis in (("pp", meshes[4], None),
                                  ("pp_dp", dp, "data")):
        toks, steps, lr, p0 = train[name]
        opt = adamw(lr)
        params_pp = tree_map(lambda t: t.clone(), pp_shard(p0, mesh))
        state = opt.init(params_pp)
        step = make_pp_lm_train_step(lm_cfg, mesh, opt, n_micro=2,
                                     data_axis=data_axis, remat=True)
        losses = []
        for _ in range(steps):
            params_pp, state, loss = step(params_pp, state,
                                          torch.from_numpy(toks))
            losses.append(float(loss))
        out[("train", name)] = (losses, _pp_gather(params_pp, mesh),
                                tuple(params_pp["layers"]["q"]["kernel"]
                                      .shape))
    errors = []
    six = dataclasses.replace(cfg, encoder_layers=6)
    for run in (lambda: encode_pipelined(params, six, mel[:4], meshes[4],
                                         n_micro=2),
                lambda: encode_pipelined(params, cfg, mel[:4], meshes[2],
                                         n_micro=3),
                lambda: lm_forward_pipelined(lm_params, lm_cfg, tok[:3],
                                             meshes[2], n_micro=2)):
        try:
            run()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


# ------------------------------------------------------------- C7 --------
def tp_c7(params, cfg, mel, tokens, prompt, eos, lm_params, lm_cfg,
          lm_tokens, steps):
    """Tensor parallelism over (1 x 2) at a head count the model axis does
    not divide (3 heads, ``d_model`` it does): Whisper's forward, encoder
    states and greedy decoding, the causal LM's forward and greedy
    KV-cached decoding, with ``shard_params(..., heads=)``; and what the
    width cut without ``heads`` does."""
    from audax_torch.infer.decode import generate
    from audax_torch.models.whisper import encode, local_heads, whisper_forward
    from audax_torch.parallel.sharding import CAUSAL_LM_TP_RULES, shard_params

    mesh = _mesh(2)
    local = shard_params(params, mesh, heads=cfg.heads)
    out = {"q_local": tuple(
        local["encoder"]["layers"]["attn"]["q"]["kernel"].shape),
           "mlp_local": tuple(
               local["encoder"]["layers"]["mlp_in"]["kernel"].shape),
           "local_heads": local_heads(local, cfg)}
    mel_t, tok_t = torch.from_numpy(mel), torch.from_numpy(tokens)
    with use_mesh(mesh), torch.no_grad():
        out["logits"] = _np(whisper_forward(local, cfg, mel_t, tok_t))
        enc = encode(local, cfg, mel_t)
    out["enc"] = _np(enc)
    out["greedy"] = _np(generate(local, cfg, enc, torch.from_numpy(prompt),
                                 max_len=12, eos_id=eos, mesh=mesh).tokens)
    try:
        with use_mesh(mesh), torch.no_grad():
            encode(shard_params(params, mesh), cfg, mel_t)
        out["width_cut"] = None
    except (ValueError, RuntimeError) as e:
        out["width_cut"] = type(e).__name__
    out["lm"] = tp_lm([(lm_params, lm_cfg)], lm_tokens, steps, mesh=mesh)[0]
    return out


# --------------------------------------------------------- streaming -----
def stream_mesh(params, cfg, tok, audio, slots):
    """``StreamingTranscriber(mesh=)`` over (data 2, model 2) at each slot
    count: every rank feeding and draining the same streams, then rank 0
    alone driving it through ``Lockstep`` (the others follow)."""
    from audax_torch.infer.continuous import Lockstep
    from audax_torch.infer.streaming import StreamingTranscriber

    mesh = _mesh(2)
    out = {}

    def segs(ss):
        return [(s.stream_id, s.index, s.text, s.audio_seconds) for s in ss]

    for n in slots:
        def make():
            return StreamingTranscriber(params, cfg, tok, batch_slots=n,
                                        window_seconds=1.0,
                                        max_new_tokens=6, mesh=mesh,
                                        device="cpu")
        st = make()
        for sid, x in audio.items():
            st.feed(sid, x)
            st.flush(sid)
        direct = segs(st.drain())
        lk = Lockstep(make(), recorded=("feed", "flush", "remove"),
                      run="drain")
        if dist.get_rank() == 0:
            for sid, x in audio.items():
                lk.feed(sid, x)
                lk.flush(sid)
            lock = segs(lk.drain())
            lk.stop()
        else:
            lk.follow()
            lock = None
        out[n] = {"direct": direct, "lockstep": lock}
    return out
