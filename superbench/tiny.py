"""Small CPU stand-ins of a cell, for the tests: a configuration file's
dict for the program's ``reduced()`` twin of an architecture (float32,
two units), a cell at 16-token prompts, and a ``BENCHMARK.json`` that
names them."""
from __future__ import annotations

from typing import Dict


def arch(name: str) -> Dict:
    from repro_torch.configs import get_config
    from repro_torch.core.pareto import pareto_subnets
    cfg = get_config(name).reduced()
    moe = bool(cfg.n_experts)
    return {
        "name": f"{name}-reduced",
        "program": {"arch": name, "size": "reduced"},
        "hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.resolved_head_dim,
        "num_hidden_layers": sum(s.repeat for s in cfg.stages),
        "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "attention_bias": cfg.qkv_bias,
        "sliding_window": cfg.sliding_window or None,
        "torch_dtype": cfg.dtype, "pattern": list(cfg.stages[0].pattern),
        "num_local_experts": cfg.n_experts or None,
        "num_experts_per_tok": cfg.top_k or None,
        "topk_options": list(cfg.elastic.topk_options) or None,
        "capacity_factor": cfg.capacity_factor if moe else None,
        "moe_intermediate_size": cfg.resolved_moe_d_ff if moe else None,
        "pareto": [dict(depth_frac=p.sub.depth_frac, ffn_frac=p.sub.ffn_frac,
                        head_frac=p.sub.head_frac, topk=p.sub.topk,
                        subnet_id=p.sub.subnet_id, acc=p.acc)
                   for p in pareto_subnets(cfg)],
    }


def cell(mode: str = "switch", token_gap: float = 1e-3) -> Dict:
    return {"config": "tiny", "traffic": f"{mode}.bursty", "slice_mode": mode,
            "prompt_tokens": 16, "batches": [1, 2, 4, 8], "slo_ms": 2000.0,
            "rate_qps": 100.0, "lead_in_s": 0.3, "trace_steps": 6,
            "judge_steps": 6, "limits": {"token_gap": token_gap},
            "trace": {"kind": "bursty", "base_share": 0.2, "base_cv2": 0.0,
                      "variant_share": 0.8, "variant_cv2": 4.0,
                      "gap_seed": 12},
            "why": "a CPU stand-in"}


def bench(names=("slo_attainment", "mean_accuracy", "p99_latency_ms",
                 "setup_s")) -> Dict:
    return {"workloads": [{"name": "tiny", "config": "tiny",
                           "traffic": "t", "chips": 1, "why": "test"}],
            "end_to_end": [{"name": n, "unit": "u"} for n in names],
            "per_layer": []}
