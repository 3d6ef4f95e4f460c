"""Assemble the port's experiments page from its dry-run JSONs and the
figures' CSV (the counterpart of the reference's
``tools/write_experiments.py``).

    PYTHONPATH=src python -m repro_torch.tools.run_figures > figures.csv
    PYTHONPATH=src python -m repro_torch.tools.write_experiments \\
        [--dir results/dryrun] [--figures figures.csv] \\
        [--out results/torch_experiments.md]

The dry-run sections come from ``tools.roofline_report`` (``summary`` and
``markdown`` of each mesh) over ``--dir``; the hardware peaks from
``analysis.roofline``.  The §Reproduction table puts each paper claim
beside the derived values of its row in ``--figures`` (the
``name,us_per_call,derived`` CSV that ``tools.run_figures`` prints);
without that file the section is left out, and the page says so.
``perf_log.md`` beside ``--dir`` (``results/perf_log.md`` by default) is
appended where it exists.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional

from repro_torch.analysis import roofline as roof
from repro_torch.tools import roofline_report as R

#: (the paper's claim, the figures' CSV row, its derived keys shown)
CLAIMS = (
    ("DLWA −86.36% @10% occupancy (superblock, ZN540)",
     "fig4a_7a_dlwa_vs_occupancy", ("reduction_at_10pct",)),
    ("Fig 8: vchunk ~4x fewer dummy pages than fixed (P8, S128, ~0% occ)",
     "fig8_geometry_sweep", ("fixed_over_vchunk2_P8S128",)),
    ("Fig 9: P16 peak ≈110 MiB/s @1 zone; P8 needs 2 zones",
     "fig9_throughput", ("peak_P16_1job", "P8_1job", "P8_2jobs")),
    ("Fig 1/7b: delaying FINISH 10%→90% ⇒ −91% baseline DLWA, +69% SA",
     "fig7b_sa_dlwa_tradeoff", ("dlwa_reduction_at_low_thr",
                                "sa_increase_delaying_finish")),
    ("Fig 7c: less total wear (−12%)", "fig7c_wear",
     ("baseline_erases", "silentzns_erases", "erase_reduction")),
    ("Fig 7c: better wear leveling", "fig7c_wear_leveling",
     ("baseline_max_wear", "silentzns_max_wear", "baseline_std",
      "silentzns_std")),
    ("Table 3: interference 1.6 → 1.1 with fine-grained elements",
     "table3_interference", ("fixed_minus_vchunk2_multiseg",)),
    ("Fig 4b/7d: interference, baseline vs SilentZNS",
     "fig4b_7d_interference", ("worst_baseline", "worst_silentzns")),
    ("Table 4: alloc latency fixed ≪ superblock < vchunk < block",
     "table4_alloc_latency", ("fixed_us", "superblock_us", "block_us")),
)


def read_figures(path: Path) -> Dict[str, Dict[str, str]]:
    """The CSV's rows: name -> {derived key: value as printed}."""
    rows = {}
    for line in path.read_text().splitlines():
        rec = line.split(",", 2)        # a derived value may hold commas
        if len(rec) == 3:
            rows[rec[0]] = dict(kv.split("=", 1) for kv in rec[2].split(";")
                                if "=" in kv)
    return rows


def reproduction(figures: Optional[Path]) -> str:
    """The §Reproduction section: each claim beside its CSV row."""
    out = ["## §Reproduction — paper claims vs ours\n"]
    if figures is None or not figures.exists():
        out.append("Left out: no figures CSV was given (`--figures`, the "
                   "output of `python -m repro_torch.tools.run_figures`).")
        return "\n".join(out) + "\n"
    rows = read_figures(figures)
    out += [f"From `{figures.name}` (`python -m "
            f"repro_torch.tools.run_figures`).\n",
            "| paper claim | ours | artifact |", "|---|---|---|"]
    for claim, name, keys in CLAIMS:
        got = rows.get(name)
        ours = ("not in the CSV" if got is None else
                ", ".join(f"{k}={got[k]}" for k in keys if k in got))
        out.append(f"| {claim} | {ours} | {name} |")
    return "\n".join(out) + "\n"


def methodology() -> str:
    return (
        "## §Methodology — roofline terms\n\n"
        "The port's dry run (`python -m repro_torch.launch.dryrun --all "
        "--mesh both`) runs one microbatch of each cell's step on `meta` "
        "leaves in a fake process group of 256 or 512 ranks, and records "
        "the collectives DTensor calls; its recurrences run their step "
        "body once there, as a compiled loop body counts once.  The three "
        "terms are **analytic per-device counts** "
        "(`repro_torch/analysis/flops.py`: matmul / attention / "
        "recurrence FLOPs; parameter, activation and KV-cache HBM "
        "traffic; TP all-reduce, FSDP all-gather, DP gradient and MoE "
        "all-to-all bytes), with the recorded collective bytes a floor on "
        "the collective term (`max(analytic, recorded)`).  Hardware: the "
        "NVIDIA H100 80GB HBM3 datasheet peaks in "
        "`repro_torch/analysis/roofline.py`: "
        f"{roof.PEAK_FLOPS_BF16 / 1e12:g} TFLOP/s dense bf16, "
        f"{roof.HBM_BW / 1e12:g} TB/s HBM3, "
        f"{roof.LINK_BW / 1e9:g} GB/s NVLink a direction, per card.  "
        "`argument GB a rank` is `memory.argument_bytes`: each rank's "
        "bytes of the placed leaves (parameters, optimizer state, caches "
        "and inputs, as the sharding rules split them); nothing is "
        "compiled, so there is no buffer-assignment peak.  `est GB` is the "
        "analytic residency.  roofline_fraction = (model_flops / peak) / "
        "max(term).\n")


def dry_run(outdir: str) -> str:
    s = R.summary(outdir)
    n = {m: len(R.table(outdir, m)) for m in ("single", "multi")}
    return (
        "## §Dry-run — placed steps on 256 and 512 ranks\n\n"
        f"- single-pod mesh (16x16, 256 ranks): **{s['cells_single_ok']}"
        f"/{n['single']} cells ok**\n"
        f"- multi-pod mesh (2x16x16, 512 ranks): **{s['cells_multi_ok']}"
        f"/{n['multi']} cells ok** (the `pod` axis joins data "
        "parallelism; gradients cross pods)\n"
        f"- failures: {s['fails']}\n")


def page(outdir: str, figures: Optional[Path]) -> str:
    parts = [
        "# Experiments (PyTorch / CUDA port)\n\n"
        "The port's reproduction of *Eliminating the Hidden Cost of Zone "
        "Management in ZNS SSDs* (SilentZNS) and its multi-pod dry run.  "
        "The storage results run on the emulated devices; the roofline "
        "terms are analytic on the H100's peaks.\n",
        reproduction(figures), methodology(), dry_run(outdir),
        "## §Roofline — single-pod (16x16)\n", R.markdown(outdir, "single"),
        "\n\nuseful = model FLOPs / analytic FLOPs; roofline frac = "
        "useful-flop time over the binding term.  Decode rows: one token "
        "amortizes no weights, so t_memory against the cache read is the "
        "number to read there.\n",
        "## §Roofline — multi-pod (2x16x16)\n", R.markdown(outdir, "multi")]
    log = Path(outdir).parent / "perf_log.md"
    if log.exists():
        parts.append("\n\n" + log.read_text())
    return "\n".join(parts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--figures", type=Path, default=None)
    ap.add_argument("--out", type=Path,
                    default=Path("results/torch_experiments.md"))
    args = ap.parse_args(argv)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(page(args.dir, args.figures))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
