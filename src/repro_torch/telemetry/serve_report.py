"""Serving energy/perf report: per-request A/D-conversion accounting (port
of ``repro.telemetry.serve_report``).

Builds the ``--energy-report`` table of ``launch.serve`` and the JSON
records ``benchmarks/serve_bench_torch.py`` writes.  Energy comes from
``core.energy`` (Eq. 6: E = e_op * N_ops); the engine meters N_ops per
request from each entry point's ``AdOpsReport``.
"""
from __future__ import annotations

from typing import Iterable

from ..core.energy import E_OP_PJ, adc_energy_pj


def request_rows(requests: Iterable) -> list:
    """One dict per finished request (JSON-ready)."""
    rows = []
    for r in requests:
        rows.append({
            "uid": r.uid,
            "prompt_tokens": int(len(r.prompt)),
            "new_tokens": len(r.generated),
            "reused_prompt_tokens": int(r.reused_tokens),
            "ttft_ms": (r.first_token_t - r.submit_t) * 1e3,
            "latency_ms": (r.finish_t - r.submit_t) * 1e3,
            "ad_ops": float(r.ad_ops),
            "prefill_ad_ops": float(r.prefill_ad_ops),
            "decode_ad_ops": float(r.decode_ad_ops),
            "ad_energy_pj": float(adc_energy_pj(r.ad_ops)),
        })
    return rows


def serve_report(engine) -> dict:
    """Aggregate engine stats + per-request rows (JSON-ready).  The
    Runtime's backend is authoritative (a ``--backend`` override may
    differ from ``cfg.pim_backend``)."""
    rt = getattr(engine, "rt", None)
    return {
        "arch": engine.cfg.name,
        "pim_backend": rt.backend if rt is not None else
        engine.cfg.pim_backend,
        "paged": engine.paged,
        "prefix_reuse": engine.prefix_reuse,
        "block_size": engine.block_size,
        "e_op_pj": E_OP_PJ,
        "stats": engine.stats(),
        "requests": request_rows(engine.finished),
    }


def format_energy_report(report: dict, max_rows: int = 12) -> str:
    """Human-readable table for the ``--energy-report`` flag."""
    st = report["stats"]
    lines = [
        f"== serve energy report ({report['arch']}, "
        f"pim={report['pim_backend']}, "
        f"paged={'on' if report['paged'] else 'off'}, "
        f"prefix_reuse={'on' if report['prefix_reuse'] else 'off'}) ==",
        f"requests {st['requests']}  decode_tokens {st['decode_tokens']}  "
        f"{st['tokens_per_s']:.1f} tok/s  ttft {st['mean_ttft_s']*1e3:.0f}ms",
        f"A/D ops total {st['total_ad_ops']:.3e} "
        f"(prefill {st['prefill_ad_ops']:.3e} / "
        f"decode {st['decode_ad_ops']:.3e})  "
        f"energy {st['total_ad_energy_pj']/1e6:.3f} uJ "
        f"(e_op={report['e_op_pj']} pJ)",
        f"reused prompt tokens {st['reused_prompt_tokens']} "
        f"(prefilled & converted once, shared via the prefix cache)",
        f"{'uid':>4} {'prompt':>6} {'reused':>6} {'new':>4} {'ttft_ms':>8} "
        f"{'ad_ops':>12} {'energy_pJ':>12}",
    ]
    for row in report["requests"][:max_rows]:
        lines.append(
            f"{row['uid']:>4} {row['prompt_tokens']:>6} "
            f"{row['reused_prompt_tokens']:>6} {row['new_tokens']:>4} "
            f"{row['ttft_ms']:>8.1f} {row['ad_ops']:>12.3e} "
            f"{row['ad_energy_pj']:>12.3e}")
    if len(report["requests"]) > max_rows:
        lines.append(f"  ... {len(report['requests']) - max_rows} more")
    return "\n".join(lines)
