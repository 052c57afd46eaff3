"""The multi-rank dry run of the port's parallelism (the counterpart of the
JAX package's ``__graft_entry__.py:dryrun_multichip``, every one of its
stages, in its order).

``python -m audax_torch.tools.dryrun_multichip N`` starts N CPU processes
joined in one gloo world (a ``file://`` store in a fresh temporary
directory), lays a (data, model) mesh over them -- model 2 when N is even
-- and runs, at tiny widths, each stage against the same computation
without a mesh:

  * EP through the expert-sharded dense MoE (experts over 'model');
  * EP through the GShard all_to_all dispatch (``parallel/ep.py``);
  * the PP x DP causal-LM train step on (stage 2, data N/2), the stack
    and its moments cut over 'stage', three steps, losses falling (N
    divisible by 4);
  * the multi-host (dcn_data, data, model) mesh forward (N divisible by 4);
  * the SP encoder (ring attention) on (data N/4, model 2, seq 2), the PP
    encoder over 2 stages, and the SP x DP fine-tune step on (data N/2,
    seq 2) against the single-device step (N divisible by 4; JAX runs
    them at 8 devices, the port's mesh must cover its world);
  * the DP x TP fine-tune step, three steps, losses falling;
  * ``accum_steps=2`` equal to the full batch under DP x TP;
  * FSDP with bfloat16 moments equal to the replicated step;
  * TP decode (``generate(mesh=)``) equal to replicated;
  * DP x TP continuous batching equal to the replicated engine.

Rank 0 prints one line a stage and ``dryrun_multichip(N): all K stages
OK``; any failure exits non-zero.
"""

from __future__ import annotations

import os
import sys
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip", "run_rank"]


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def run_rank(n: int) -> int:
    """The stages on this rank of an initialised world of ``n``; returns
    the number of stages."""
    from audax_torch.core.config import (FineTuneConfig, MeshConfig,
                                         WhisperConfig)
    from audax_torch.infer.continuous import ContinuousBatcher
    from audax_torch.infer.decode import generate
    from audax_torch.models.causal_lm import (CausalLMConfig, _moe_block,
                                              init_causal_lm, lm_forward)
    from audax_torch.models.whisper import (encode, init_whisper_params,
                                            layer_params, whisper_forward)
    from audax_torch.parallel.comm import all_gather_cat
    from audax_torch.parallel.ep import moe_expert_parallel
    from audax_torch.parallel.fsdp import fsdp_shard_state, shard_state
    from audax_torch.parallel.mesh import (batch_group, make_mesh,
                                           make_multihost_mesh,
                                           make_named_mesh, shard_batch,
                                           use_mesh)
    from audax_torch.parallel.pp import (encode_pipelined,
                                         make_pp_lm_train_step, pp_shard)
    from audax_torch.parallel.sp import (encode_sequence_parallel,
                                         make_sp_finetune_step)
    from audax_torch.train.optim import adamw
    from audax_torch.parallel.sharding import CAUSAL_LM_TP_RULES, shard_params
    from audax_torch.symbolic.bpe import train_bpe
    from audax_torch.symbolic.tokenizer import WhisperTokenizer
    from audax_torch.train.seq2seq import (collate_seq2seq, init_finetune,
                                           make_finetune_step)

    lead = dist.get_rank() == 0
    stages = []

    def ok(msg: str) -> None:
        stages.append(msg)
        if lead:
            print(f"[dryrun] stage {len(stages)}: {msg} OK", flush=True)

    model_axis = 2 if n % 2 == 0 else 1
    mesh = make_mesh(MeshConfig(model=model_axis), device="cpu")
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rng = np.random.default_rng(0)

    # ---- expert parallelism --------------------------------------------
    moe_cfg = CausalLMConfig(vocab_size=96, d_model=32, layers=2, heads=4,
                             kv_heads=2, ffn_dim=64, qk_norm=True,
                             num_experts=4, experts_per_tok=2,
                             moe_ffn_dim=48, moe_impl="dense")
    moe = init_causal_lm(moe_cfg, torch.Generator().manual_seed(1),
                         device="cpu")
    toks = torch.from_numpy(rng.integers(0, 96, (4, 7)))
    ref = lm_forward(moe, moe_cfg, toks)
    with use_mesh(mesh), torch.no_grad():
        out = lm_forward(shard_params(moe, mesh, CAUSAL_LM_TP_RULES),
                         moe_cfg, toks)
    err = _err(out, ref)
    assert err < 1e-4, err
    ok(f"EP Qwen3-MoE forward (experts over 'model', E=4) "
       f"max|diff|={err:.2e}")

    layer0 = layer_params(moe["layers"], 0)
    x = torch.from_numpy(rng.standard_normal((4, 8, 32)).astype(np.float32))
    with torch.no_grad():
        ref = _moe_block(layer0, moe_cfg, x)
        out = moe_expert_parallel(layer0, moe_cfg, x, mesh)
    err = _err(out, ref)
    assert err < 1e-4, err
    ok(f"EP all_to_all dispatch (GShard schedule) max|diff|={err:.2e}")

    # ---- pipeline-parallel training composed with DP ---------------------
    if n % 4 == 0:
        pp_mesh = make_named_mesh([("stage", 2), ("data", n // 2)],
                                  device="cpu")
        pp_cfg = CausalLMConfig(vocab_size=96, d_model=32, layers=4, heads=4,
                                kv_heads=2, ffn_dim=64)
        pp_params = pp_shard(init_causal_lm(
            pp_cfg, torch.Generator().manual_seed(2), device="cpu"), pp_mesh)
        pp_opt = adamw(1e-2)
        pp_state = pp_opt.init(pp_params)
        pp_step = make_pp_lm_train_step(pp_cfg, pp_mesh, pp_opt, n_micro=2,
                                        data_axis="data", remat=True)
        pp_toks = torch.from_numpy(rng.integers(0, pp_cfg.vocab_size,
                                                (2 * (n // 2), 9)))
        pp_losses = []
        for _ in range(3):
            pp_params, pp_state, pl = pp_step(pp_params, pp_state, pp_toks)
            pp_losses.append(float(pl))
        assert pp_losses[-1] < pp_losses[0], pp_losses
        q = tuple(pp_params["layers"]["q"]["kernel"].shape)
        assert q[0] == pp_cfg.layers // 2, q
        ok(f"PP x DP LM train step (mesh {{'stage': 2, 'data': {n // 2}}}, "
           f"stage-cut stack + moments, q {q}) "
           f"losses={[round(v, 4) for v in pp_losses]} (decreasing)")

    # ---- Whisper: multi-host forward, fine-tune, decode, serve ----------
    cfg = WhisperConfig(n_mels=80, n_audio_ctx=64, d_model=64, heads=4,
                        encoder_layers=2, decoder_layers=2, vocab_size=512,
                        n_text_ctx=32)
    params0 = init_whisper_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    b = 8
    mel = torch.from_numpy(rng.standard_normal(
        (b, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32))
    if n % 4 == 0:
        mh = make_multihost_mesh(MeshConfig(model=model_axis), num_hosts=2,
                                 device="cpu")
        tok8 = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 8)))
        ref = whisper_forward(params0, cfg, mel, tok8)
        with use_mesh(mh), torch.no_grad():
            local = whisper_forward(shard_params(params0, mh), cfg,
                                    *shard_batch(mh, [mel, tok8]))
        out = all_gather_cat(local, batch_group(mh), 0)
        err = _err(out, ref)
        assert err < 1e-4, err
        ok(f"multi-host mesh {dict(zip(mh.mesh_dim_names, mh.shape))} "
           f"forward max|diff|={err:.2e}")

    lab = collate_seq2seq([[3, 4, 5, 2]] * b, decoder_start_id=1,
                          pad_multiple=4)
    batch = {"mel": mel,
             "decoder_input_ids": torch.from_numpy(lab["decoder_input_ids"]),
             "labels": torch.from_numpy(lab["labels"])}
    local = shard_batch(mesh, batch)
    ft = FineTuneConfig(learning_rate=1e-3, warmup_steps=1, max_steps=10,
                        lora_rank=0)

    # ---- sequence and pipeline parallelism -------------------------------
    if n % 4 == 0:
        with torch.no_grad():
            ref = encode(params0, cfg, mel)
            mesh3 = make_named_mesh([("data", n // 4), ("model", 2),
                                     ("seq", 2)], device="cpu")
            sp = all_gather_cat(encode_sequence_parallel(
                params0, cfg, mel, mesh3), mesh3.get_group("data"), 0)
            err = _err(sp, ref)
            assert err < 1e-3, err
            ok(f"SP encoder (ring attention) over "
               f"{dict(zip(mesh3.mesh_dim_names, mesh3.shape))} "
               f"max|diff|={err:.2e}")
            stage_mesh = make_named_mesh([("stage", 2), ("data", n // 2)],
                                         device="cpu")
            err = _err(encode_pipelined(params0, cfg, mel, stage_mesh,
                                        n_micro=2), ref)
            assert err < 1e-3, err
            ok(f"PP encoder over 2 stages max|diff|={err:.2e}")
        sp_mesh = make_named_mesh([("data", n // 2), ("seq", 2)],
                                  device="cpu")
        _, m_ref = make_finetune_step(cfg, remat=False)(
            init_finetune(params0, ft), batch)
        _, m_sp = make_sp_finetune_step(cfg, sp_mesh, ft)(
            init_finetune(params0, ft), batch)
        l_ref, l_sp = float(m_ref["loss"]), float(m_sp["loss"])
        assert abs(l_sp - l_ref) < 1e-3 * max(abs(l_ref), 1.0), (l_sp,
                                                                  l_ref)
        ok(f"SP x DP fine-tune step (ring-attention grads, mesh "
           f"{dict(zip(sp_mesh.mesh_dim_names, sp_mesh.shape))}) loss "
           f"matches single-device ({l_sp:.4f} vs {l_ref:.4f})")
    step = make_finetune_step(cfg, remat=True)
    state = shard_state(init_finetune(params0, ft), mesh)
    losses = []
    for _ in range(3):
        state, m = step(state, local)
        losses.append(float(m["loss"]))
    _, m_ref = make_finetune_step(cfg, remat=False)(
        init_finetune(params0, ft), batch)
    assert losses[-1] < losses[0], losses
    assert abs(losses[0] - float(m_ref["loss"])) < 1e-4 * max(
        abs(losses[0]), 1.0), (losses[0], float(m_ref["loss"]))
    ok(f"DP x TP fine-tune: mesh={shape} losses="
       f"{[round(v, 4) for v in losses]} (decreasing, first = "
       f"single-device)")

    st2 = shard_state(init_finetune(params0, ft), mesh)
    _, m2 = make_finetune_step(cfg, remat=True, accum_steps=2)(st2, local)
    l1, l2 = losses[0], float(m2["loss"])
    assert abs(l1 - l2) < 1e-4 * max(abs(l1), 1.0), (l1, l2)
    ok(f"accum_steps=2 loss matches full batch ({l1:.4f} vs {l2:.4f}) "
       f"under DP x TP")

    ft_lp = FineTuneConfig(learning_rate=1e-3, warmup_steps=1, max_steps=10,
                           lora_rank=0, moment_dtype="bfloat16")
    st_fs = fsdp_shard_state(init_finetune(params0, ft_lp), mesh)
    # the first leaf of >= 4096 elements: cut over 'data' on a free dim
    spec = st_fs.layout.specs["decoder"]["layers"]["mlp_in"]["kernel"]
    mu = st_fs.opt_state.mu["decoder"]["layers"]["mlp_in"]["kernel"]
    assert "data" in spec or shape["data"] == 1, spec
    assert mu.dtype == torch.bfloat16, mu.dtype
    _, m_fs = step(st_fs, local)
    l_fs = float(m_fs["loss"])
    assert abs(l_fs - l1) < 1e-4 * max(abs(l1), 1.0), (l_fs, l1)
    ok(f"FSDP (ZeRO-3 over 'data' x TP, bf16 moments {tuple(mu.shape)}) "
       f"loss matches replicated ({l_fs:.4f} vs {l1:.4f})")

    trained = state.full_params()
    with torch.no_grad():
        enc = encode(trained, cfg, mel)
    prompt = torch.full((b, 1), 3, dtype=torch.long)
    rep = generate(trained, cfg, enc, prompt, max_len=8, eos_id=2)
    tp = generate(shard_params(trained, mesh), cfg, enc, prompt, max_len=8,
                  eos_id=2, mesh=mesh)
    assert torch.equal(tp.tokens, rep.tokens)
    ok("TP decode (heads over 'model', rows over 'data') matches "
       "replicated")

    tok = WhisperTokenizer(train_bpe(["hello world"] * 3, vocab_size=280))
    scfg = WhisperConfig(n_mels=80, n_audio_ctx=50, d_model=32,
                         encoder_layers=1, decoder_layers=1, heads=4,
                         vocab_size=tok.vocab_size, n_text_ctx=16)
    sparams = init_whisper_params(scfg, torch.Generator().manual_seed(3),
                                  device="cpu")
    clips = [0.01 * rng.standard_normal(16000).astype(np.float32)
             for _ in range(3)]

    def serve(p, m):
        cb = ContinuousBatcher(p, scfg, tok, slots=2, window_seconds=1.0,
                               max_new_tokens=5, steps_per_sync=4, mesh=m,
                               device="cpu")
        for i, clip in enumerate(clips):
            cb.submit(f"r{i}", clip)
        return {r.request_id: r.tokens for r in cb.run()}

    rep_serve = serve(sparams, None)
    tp_serve = serve(shard_params(sparams, mesh), mesh)
    assert tp_serve == rep_serve, (tp_serve, rep_serve)
    ok(f"DP x TP continuous batching (3 requests / 2 slots over mesh "
       f"{shape}) matches replicated")
    return len(stages)


def _child(rank: int, n: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=n)
        k = run_rank(n)
        dist.barrier()
        if rank == 0:
            with open(out, "w") as fh:
                fh.write(str(k))
        dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


def dryrun_multichip(n: int = 4, timeout: float = 600.0) -> int:
    """Run the stages over ``n`` CPU ranks; returns the stage count
    (raises ``RuntimeError`` if a rank fails or the world overruns
    ``timeout`` seconds)."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "n")
        procs = [ctx.Process(target=_child, args=(r, n, store, out))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                codes = [p.exitcode for p in procs]
                if all(c is not None for c in codes) or any(codes):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad or not os.path.exists(out):
            raise RuntimeError(f"dryrun_multichip({n}): ranks {bad} failed")
        with open(out) as fh:
            k = int(fh.read())
    print(f"dryrun_multichip({n}): all {k} stages OK", flush=True)
    return k


if __name__ == "__main__":
    try:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
