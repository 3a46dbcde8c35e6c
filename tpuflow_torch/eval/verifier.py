"""Verification harness: run both LK modes over the 13-pattern suite,
classify against thresholds, and gate on baseline regression.

The port of ``tpuflow.eval.verifier``, with the same pattern categories,
Pass/Warning/Fail thresholds, test regions, the mae_u/mae_v/epe 10%
regression gate with its baseline-zero rule and provenance guard, the
md/JSON reports, and a nonzero exit on regression. It imports neither JAX
nor ``tpuflow``: the suite comes from the committed fixture
(``patterns.load_suite``), and the committed baselines under
``tpuflow/eval/data/`` are read as files. ``backend="cuda"`` runs the
hand-written kernels, ``backend="torch"`` the parity path; a baseline's
``backend`` is recorded in the JAX package's names, ``pallas`` and
``jnp``. The flow is computed on the card and the run fails without one,
unless the caller asks for the CPU (``device="cpu"``, ``--device cpu``),
where the kernels' plain versions run.

The reference's other flags are here too: ``--suite-dir DIR`` reads a
suite in the reference generator's layout (``suite_index.json``, one
directory a pattern), writing the committed suite there first where DIR
has no index; ``--config YAML`` overrides thresholds, categories, the test
region and named pyramid configs (``apply_config``; PyYAML, imported only
then; the defaults are the JAX package's
``tpuflow/eval/verification_config.yaml``, read by path as the baselines
are);
without ``--no-visualizations`` the showcase patterns' plots and
per-level snapshots are written under ``OUTPUT_DIR/plots`` where
matplotlib imports, and their skip is printed where it does not (the GPU
host has none).

Run: ``python -m tpuflow_torch.eval.verifier --pyramid-config default
--backend cuda --compare-baseline --baseline
tpuflow/eval/data/pallas_baseline.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpuflow_torch.core.config import PYRAMID_CONFIGS, PyramidConfig
from tpuflow_torch.eval import patterns as patterns_mod
from tpuflow_torch.eval.metrics import compute_all_metrics, compute_all_metrics_dense
from tpuflow_torch.eval.timing import resolve_device
from tpuflow_torch.flow import lucas_kanade_pyramidal, lucas_kanade_single_scale

BASELINE_DIR = Path(__file__).resolve().parents[2] / "tpuflow" / "eval" / "data"
REFERENCE_BASELINE = BASELINE_DIR / "reference_baseline.json"
# Each config with a committed fast-path baseline.
PALLAS_BASELINES: Dict[str, str] = {
    "default": "pallas_baseline.json",
    "narrow_vertical": "pallas_narrow_baseline.json",
    "adaptive_vertical": "pallas_adaptive_baseline.json",
    "relaxed_order": "pallas_relaxed_baseline.json",
    "production": "pallas_production_baseline.json",
    "production_fullband": "pallas_production_fullband_baseline.json",
}
# This package's backend -> the JAX package's name for the same path.
BASELINE_BACKEND = {"cuda": "pallas", "torch": "jnp"}

# Pass/Warning thresholds per category (reference:
# verification_config.yaml:6-27).
THRESHOLDS: Dict[str, Tuple[float, float]] = {
    "translation": (0.5, 2.0),
    "rotation": (1.0, 3.0),
    "zoom": (1.0, 3.0),
    "combined": (2.0, 5.0),
}

# Pattern -> category (reference: verification_config.yaml:29-49).
PATTERN_CATEGORIES: Dict[str, str] = {
    "translate_small": "translation",
    "translate_medium": "translation",
    "translate_large": "translation",
    "translate_extreme": "translation",
    "translate_vertical": "translation",
    "translate_diagonal": "translation",
    "no_motion": "translation",
    "rotate_small": "rotation",
    "rotate_medium": "rotation",
    "rotate_large": "rotation",
    "zoom_in": "zoom",
    "zoom_out": "zoom",
    "translate_rotate": "combined",
}

CENTER_CROP = 80  # reference: verification_config.yaml:107
BORDER = 10       # reference: optical_flow_verifier.py:135

DEFAULT_CONFIG = BASELINE_DIR.parent / "verification_config.yaml"
# The patterns whose plots the CLI writes.
SHOWCASE = ("translate_medium", "rotate_small", "translate_extreme")


def apply_config(path) -> dict:
    """Load a verifier YAML config and apply its overrides: thresholds,
    pattern categories, the test region's crop and border, and named
    pyramid configs (added, or replaced field by field from the named
    config or ``default``). Returns the parsed dict (for
    ``regression.threshold_percent``). Needs PyYAML."""
    import dataclasses

    try:
        import yaml
    except ImportError as exc:
        raise ImportError("--config needs PyYAML, which is not installed") from exc

    global CENTER_CROP, BORDER
    cfg = yaml.safe_load(Path(path).read_text()) or {}
    for cat, (p, w) in (cfg.get("thresholds") or {}).items():
        THRESHOLDS[cat] = (float(p), float(w))
    PATTERN_CATEGORIES.update(cfg.get("pattern_categories") or {})
    region = cfg.get("test_region") or {}
    CENTER_CROP = int(region.get("center_crop", CENTER_CROP))
    BORDER = int(region.get("border", BORDER))
    for name, pc in (cfg.get("pyramid_configs") or {}).items():
        base = PYRAMID_CONFIGS.get(name, PYRAMID_CONFIGS["default"])
        PYRAMID_CONFIGS[name] = dataclasses.replace(base, **pc)
    return cfg


def get_test_region_mask(
    shape: Tuple[int, int], pattern_name: str, center_crop: Optional[int] = None
) -> np.ndarray:
    """Mask of pixels to score: the central crop (``CENTER_CROP``) for
    rotation/zoom/combined patterns, the frame less ``BORDER`` px
    otherwise; ``--config`` can override both."""
    if center_crop is None:
        center_crop = CENTER_CROP
    height, width = shape
    mask = np.zeros((height, width), dtype=bool)
    varies = (
        "rotate" in pattern_name
        or "zoom" in pattern_name
        or "translate_rotate" in pattern_name
    )
    if varies:
        cy, cx = height // 2, width // 2
        half = center_crop // 2
        mask[cy - half : cy + half, cx - half : cx + half] = True
    else:
        mask[BORDER:-BORDER, BORDER:-BORDER] = True
    return mask


def classify_result(mae_u: float, mae_v: float, pattern_name: str) -> str:
    """Pass/Warning/Fail on the worst component MAE."""
    category = PATTERN_CATEGORIES.get(pattern_name, "translation")
    mae_pass, mae_warning = THRESHOLDS[category]
    mae_max = max(mae_u, mae_v)
    if mae_max <= mae_pass:
        return "Pass"
    if mae_max <= mae_warning:
        return "Warning"
    return "Fail"


def _make_runners(
    pyramid_config: PyramidConfig, backend: str, gaussian_weights: bool = False,
    device: torch.device | str | None = None,
):
    """Single-scale and pyramidal runners: numpy frames in, numpy flow out,
    computed on ``device``: the card unless the caller names another (on
    the CPU the kernels' plain versions run); raises without a card."""
    dev = resolve_device(device)

    def single(prev, curr):
        u, v = lucas_kanade_single_scale(
            torch.from_numpy(prev).to(dev), torch.from_numpy(curr).to(dev),
            pyramid_config.window_size, backend=backend, gaussian_weights=gaussian_weights,
        )
        return u.cpu().numpy(), v.cpu().numpy()

    def pyramidal(prev, curr):
        u, v = lucas_kanade_pyramidal(
            torch.from_numpy(prev).to(dev), torch.from_numpy(curr).to(dev),
            config=pyramid_config, backend=backend,
        )
        return u.cpu().numpy(), v.cpu().numpy()

    return single, pyramidal


def verify_pattern(
    pattern_name: str,
    pattern_data: Dict[str, Any],
    runners,
    pyramid_config_name: str = "default",
    verbose: bool = True,
    dense_gt: bool = False,
) -> Dict[str, Any]:
    """Run both modes on one pattern and score them. ``dense_gt`` adds a
    per-mode ``dense_metrics`` block against the exact per-pixel affine
    field (not part of the regression gate)."""
    single, pyramidal = runners
    frame_prev = pattern_data["frame_prev"]
    frame_curr = pattern_data["frame_curr"]
    motion = pattern_data["metadata"]["motion_parameters"]
    u_true, v_true = motion["dx"], motion["dy"]

    mask = get_test_region_mask(frame_prev.shape, pattern_name)

    u_s, v_s = single(frame_prev, frame_curr)
    metrics_single = compute_all_metrics(u_s, v_s, u_true, v_true, mask)
    u_p, v_p = pyramidal(frame_prev, frame_curr)
    metrics_pyr = compute_all_metrics(u_p, v_p, u_true, v_true, mask)

    status_single = classify_result(
        metrics_single["mae_u"], metrics_single["mae_v"], pattern_name
    )
    status_pyr = classify_result(metrics_pyr["mae_u"], metrics_pyr["mae_v"], pattern_name)

    if verbose:
        print(
            f"{pattern_name:22s} single: mae=({metrics_single['mae_u']:.3f},"
            f"{metrics_single['mae_v']:.3f}) epe={metrics_single['epe']:.3f}"
            f" [{status_single}]  pyramidal: mae=({metrics_pyr['mae_u']:.3f},"
            f"{metrics_pyr['mae_v']:.3f}) epe={metrics_pyr['epe']:.3f} [{status_pyr}]"
        )

    out_single: Dict[str, Any] = {"metrics": metrics_single, "status": status_single}
    out_pyr: Dict[str, Any] = {
        "metrics": metrics_pyr,
        "status": status_pyr,
        "config": pyramid_config_name,
    }
    if dense_gt:
        h, w = frame_prev.shape
        fields = ("name", "dx", "dy", "rotation", "scale", "description")
        mp = patterns_mod.MotionParameters(**{k: motion[k] for k in fields if k in motion})
        gu, gv, visible = patterns_mod.dense_ground_truth(mp, w, h)
        dmask = mask & visible
        out_single["dense_metrics"] = compute_all_metrics_dense(u_s, v_s, gu, gv, dmask)
        out_pyr["dense_metrics"] = compute_all_metrics_dense(u_p, v_p, gu, gv, dmask)
    return {
        "pattern_name": pattern_name,
        "ground_truth": {"u": u_true, "v": v_true},
        "num_test_pixels": int(mask.sum()),
        "single_scale": out_single,
        "pyramidal": out_pyr,
        "flow_fields": {"single": (u_s, v_s), "pyramidal": (u_p, v_p)},
    }


def _strip_arrays(result: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in result.items() if k != "flow_fields"}


# ---------------------------------------------------------------------------
# Baseline regression
# ---------------------------------------------------------------------------


def compare_metrics(
    current: Dict[str, float],
    baseline: Dict[str, float],
    threshold_percent: float = 10.0,
) -> Dict[str, Any]:
    """Flag mae_u/mae_v/epe changes beyond the threshold; a metric whose
    baseline is 0 is flagged as soon as it exceeds 1e-6."""
    differences: Dict[str, Any] = {}
    flags: List[str] = []
    for metric in ("mae_u", "mae_v", "epe"):
        curr_val = current.get(metric, 0.0)
        base_val = baseline.get(metric, 0.0)
        if base_val < 1e-6:
            if curr_val > 1e-6:
                flags.append(f"{metric}: {curr_val:.4f} (baseline was 0)")
            continue
        change = 100.0 * (curr_val - base_val) / base_val
        differences[metric] = {
            "current": curr_val,
            "baseline": base_val,
            "change_percent": change,
        }
        if abs(change) > threshold_percent:
            flags.append(
                f"{metric}: {change:+.1f}% change "
                f"(current={curr_val:.4f}, baseline={base_val:.4f})"
            )
    return {"passed": not flags, "differences": differences, "flags": flags}


def compare_against_baseline(
    results: List[Dict[str, Any]],
    baseline_path: Path,
    threshold_percent: float = 10.0,
    verbose: bool = True,
    backend: str | None = None,
) -> bool:
    """Whole-suite regression check; True = no regressions.

    Provenance guard: a baseline captured with another backend (``cuda``
    matches ``pallas``, ``torch`` matches ``jnp``) or another pyramid config
    fails the check outright instead of producing spurious metric flags or
    accidental passes."""
    if not baseline_path.exists():
        print(f"No baseline found at {baseline_path}; skipping regression check.")
        return True
    doc = json.loads(baseline_path.read_text())
    baseline = doc.get("patterns", {})
    base_backend = doc.get("backend")
    run_backend = BASELINE_BACKEND.get(backend, backend) if backend is not None else None
    if run_backend is not None and base_backend is not None and run_backend != base_backend:
        print(
            f"PROVENANCE MISMATCH: baseline {baseline_path.name} was "
            f"captured with backend={base_backend!r} but this run uses "
            f"backend={backend!r} ({run_backend!r}); pass the matching --baseline."
        )
        return False

    all_passed = True
    for result in results:
        name = result["pattern_name"]
        if name not in baseline:
            if verbose:
                print(f"  {name}: not in baseline (skipping)")
            continue
        run_cfg = result.get("pyramidal", {}).get("config")
        base_cfg = baseline[name].get("pyramidal", {}).get("config")
        if run_cfg is not None and base_cfg is not None and run_cfg != base_cfg:
            print(
                f"  PROVENANCE MISMATCH {name}: baseline pyramid config "
                f"{base_cfg!r} != run config {run_cfg!r}"
            )
            all_passed = False
            continue
        for mode in ("single_scale", "pyramidal"):
            cmp = compare_metrics(
                result[mode]["metrics"],
                baseline[name][mode]["metrics"],
                threshold_percent,
            )
            if not cmp["passed"]:
                all_passed = False
                if verbose:
                    print(f"  REGRESSION {name} ({mode}):")
                    for flag in cmp["flags"]:
                        print(f"    - {flag}")
    if verbose:
        print(
            "Regression check: "
            + ("all patterns within threshold" if all_passed else "FAILURES detected")
        )
    return all_passed


def update_baseline(
    results: List[Dict[str, Any]],
    baseline_path: Path,
    backend: str | None = None,
) -> None:
    """Rewrite the baseline from current results, recording the backend in
    the JAX package's names for the provenance guard."""
    data: Dict[str, Any] = {
        "version": "1.0",
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "patterns": {r["pattern_name"]: _strip_arrays(r) for r in results},
    }
    if backend is not None:
        data["backend"] = BASELINE_BACKEND.get(backend, backend)
    baseline_path.parent.mkdir(parents=True, exist_ok=True)
    baseline_path.write_text(json.dumps(data, indent=2))
    print(f"Baseline updated: {baseline_path}")


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------


def generate_markdown_table(results: List[Dict[str, Any]]) -> str:
    lines = ["# Optical Flow Verification Results\n"]
    for mode, title in (
        ("single_scale", "Single-Scale Lucas-Kanade"),
        ("pyramidal", "Pyramidal Lucas-Kanade"),
    ):
        lines.append(f"## {title}\n")
        lines.append(
            "| Pattern | Ground Truth | MAE (u) | MAE (v) | RMSE | EPE | AAE | Status |"
        )
        lines.append(
            "|---------|--------------|---------|---------|------|-----|-----|--------|"
        )
        for r in results:
            gt = r["ground_truth"]
            m = r[mode]["metrics"]
            lines.append(
                f"| {r['pattern_name']:20s} | ({gt['u']:4.1f}, {gt['v']:4.1f}) | "
                f"{m['mae_u']:5.3f} | {m['mae_v']:5.3f} | {m['rmse']:5.3f} | "
                f"{m['epe']:5.3f} | {m['aae']:5.2f}° | {r[mode]['status']} |"
            )
        lines.append("")

    if any("dense_metrics" in r["single_scale"] for r in results):
        lines.append("## Dense Ground Truth (exact per-pixel affine field)\n")
        lines.append("| Pattern | Mode | MAE (u) | MAE (v) | RMSE | EPE | AAE |")
        lines.append("|---------|------|---------|---------|------|-----|-----|")
        for r in results:
            for mode, label in (("single_scale", "single"), ("pyramidal", "pyramidal")):
                m = r[mode]["dense_metrics"]
                lines.append(
                    f"| {r['pattern_name']:20s} | {label:9s} | "
                    f"{m['mae_u']:5.3f} | {m['mae_v']:5.3f} | "
                    f"{m['rmse']:5.3f} | {m['epe']:5.3f} | {m['aae']:5.2f}° |"
                )
        lines.append("")
    return "\n".join(lines)


def save_results_json(results: List[Dict[str, Any]], output_path: Path) -> None:
    data = {
        "version": "1.0",
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "patterns": {r["pattern_name"]: _strip_arrays(r) for r in results},
    }
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(json.dumps(data, indent=2))


# ---------------------------------------------------------------------------
# Suite runner / CLI
# ---------------------------------------------------------------------------


def load_patterns(
    suite_dir: Optional[Path] = None,
    pattern_names: Optional[List[str]] = None,
    verbose: bool = True,
) -> Dict[str, Dict[str, Any]]:
    """The patterns to verify, name -> frames and metadata: from the
    committed suite, or from ``suite_dir`` in the reference generator's
    layout (the committed suite is written there first where the
    directory has no ``suite_index.json``). Unknown names exit 1."""
    if suite_dir is None:
        suite = patterns_mod.load_suite()
        available = list(suite)
    else:
        suite_dir = Path(suite_dir)
        if not (suite_dir / "suite_index.json").exists():
            if verbose:
                print(f"Writing the committed test suite -> {suite_dir}")
            patterns_mod.write_suite(suite_dir)
        index = json.loads((suite_dir / "suite_index.json").read_text())
        available = list(index["patterns"])
    unknown = [n for n in pattern_names or () if n not in available]
    if unknown:
        raise SystemExit(
            f"Unknown pattern(s): {', '.join(unknown)}. "
            f"Available: {', '.join(sorted(available))}"
        )
    names = pattern_names or available
    if suite_dir is None:
        return {name: suite[name] for name in names}
    return {name: patterns_mod.load_test_pattern(suite_dir / name) for name in names}


def run_suite(
    pattern_names: Optional[List[str]] = None,
    pyramid_config_name: str = "default",
    backend: str = "torch",
    verbose: bool = True,
    gaussian_weights: bool = False,
    dense_gt: bool = False,
    device: torch.device | str | None = None,
    suite_dir: Optional[Path] = None,
) -> List[Dict[str, Any]]:
    """Run verification over the committed suite, or the suite in
    ``suite_dir`` (see ``load_patterns``), on ``device``: the card unless
    the caller names another; raises without a card."""
    suite = load_patterns(suite_dir, pattern_names, verbose)
    cfg = PYRAMID_CONFIGS[pyramid_config_name]
    runners = _make_runners(cfg, backend, gaussian_weights, device)
    return [
        verify_pattern(
            name, data, runners, pyramid_config_name, verbose=verbose, dense_gt=dense_gt,
        )
        for name, data in suite.items()
    ]


def save_plots(
    results: List[Dict[str, Any]],
    suite_dir: Optional[Path],
    out_dir: Path,
    pyramid_config: PyramidConfig,
    backend: str,
    device: torch.device | str | None,
) -> bool:
    """The showcase patterns' flow and error plots and per-level
    snapshots under ``out_dir``. Where matplotlib does not import, prints
    the skip and returns False."""
    from tpuflow_torch.eval import visualize

    try:
        visualize._plt()
    except ImportError as exc:
        print(f"(visualizations skipped: {exc})")
        return False
    dev = resolve_device(device)
    shown = [r for r in results if r["pattern_name"] in SHOWCASE]
    suite = load_patterns(suite_dir, [r["pattern_name"] for r in shown], verbose=False)
    for r in shown:
        name = r["pattern_name"]
        visualize.save_pattern_plots(r, out_dir)
        data = suite[name]
        # The per-level snapshots re-run the pyramidal solve, as the
        # reference's do.
        _, _, levels = lucas_kanade_pyramidal(
            torch.from_numpy(data["frame_prev"]).to(dev),
            torch.from_numpy(data["frame_curr"]).to(dev),
            config=pyramid_config, backend=backend, return_levels=True,
        )
        visualize.save_pyramid_levels(
            [(u.cpu().numpy(), v.cpu().numpy()) for u, v in levels], out_dir / name / "levels")
    return True


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Verify tpuflow_torch optical flow against the 13-pattern suite"
    )
    parser.add_argument(
        "--suite-dir", type=str, default=None,
        help="a suite in the reference generator's layout (the committed suite "
        "is written there first where it has no suite_index.json); default: "
        "the committed suite",
    )
    parser.add_argument("--pattern", type=str, nargs="+", default=None)
    parser.add_argument(
        "--pyramid-config", type=str, default="default",
        help=f"named pyramid config (built-in: {', '.join(sorted(PYRAMID_CONFIGS))}; "
        "--config can add more)",
    )
    parser.add_argument("--backend", type=str, default="torch", choices=["torch", "cuda"])
    parser.add_argument(
        "--device", type=str, default="cuda", choices=["cuda", "cpu"],
        help="where the flow is computed: the card (default; fails without one) "
        "or the CPU, where the kernels' plain versions run",
    )
    parser.add_argument(
        "--gaussian-weights", action="store_true",
        help="Gaussian window weighting for single scale (the committed "
        "baselines are unweighted)",
    )
    parser.add_argument(
        "--config", type=str, default=None, metavar="YAML",
        help="verifier config overriding thresholds/categories/test region/pyramid "
        "configs (needs PyYAML; defaults in tpuflow/eval/verification_config.yaml)",
    )
    parser.add_argument("--compare-baseline", action="store_true")
    parser.add_argument("--update-baseline", action="store_true")
    parser.add_argument("--regression-threshold", type=float, default=None,
                        help="percent (default: the config's, else 10)")
    parser.add_argument(
        "--baseline", type=str, default=str(REFERENCE_BASELINE),
        help="Baseline JSON (defaults to the reference repo's committed baseline)",
    )
    parser.add_argument("--output-dir", type=str, default="results")
    parser.add_argument("--no-visualizations", action="store_true",
                        help="skip the showcase plots (they need matplotlib)")
    parser.add_argument(
        "--dense-gt", action="store_true",
        help="add metrics against the exact per-pixel affine flow field "
        "(extra report section, not gated)",
    )
    args = parser.parse_args(argv)

    file_cfg = apply_config(args.config) if args.config else {}
    if args.regression_threshold is None:
        args.regression_threshold = float(
            (file_cfg.get("regression") or {}).get("threshold_percent", 10.0)
        )
    if args.pyramid_config not in PYRAMID_CONFIGS:
        raise SystemExit(
            f"Unknown pyramid config '{args.pyramid_config}'. "
            f"Available: {', '.join(sorted(PYRAMID_CONFIGS))}"
        )

    # run_suite checks the names before it resolves the device, so an
    # unknown name exits 1 with its message on any machine.
    suite_dir = Path(args.suite_dir) if args.suite_dir else None
    results = run_suite(
        pattern_names=args.pattern,
        pyramid_config_name=args.pyramid_config,
        backend=args.backend,
        gaussian_weights=args.gaussian_weights,
        dense_gt=args.dense_gt,
        device=args.device,
        suite_dir=suite_dir,
    )
    print(f"backend={args.backend} on {args.device}")

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    md = generate_markdown_table(results)
    (out_dir / "verification_results.md").write_text(md)
    save_results_json(results, out_dir / "verification_results.json")
    print("\n" + md)

    if not args.no_visualizations:
        save_plots(results, suite_dir, out_dir / "plots", PYRAMID_CONFIGS[args.pyramid_config],
                   args.backend, args.device)

    if args.update_baseline:
        update_baseline(results, Path(args.baseline), backend=args.backend)

    if args.compare_baseline:
        ok = compare_against_baseline(
            results, Path(args.baseline), args.regression_threshold, backend=args.backend,
        )
        if not ok:
            print("\nRegression detected! Review changes before committing.")
            sys.exit(1)


if __name__ == "__main__":
    main()
