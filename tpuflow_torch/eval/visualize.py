"""Flow-field visualization: quiver plots, error heatmaps, the 4-panel
diagnostic with a cross-implementation comparison, per-level pyramid
snapshots and the verifier's showcase plots.

A copy of ``tpuflow.eval.visualize``. Its inputs are numpy arrays (pass
``tensor.cpu().numpy()``). Matplotlib is optional and imported only when
a plot is drawn; the GPU host has none.

Run: ``python -m tpuflow_torch.eval.visualize FLOW.txt [--compare
OTHER.txt] [--color] --output PNG``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plots need matplotlib, which is not installed") from exc

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def flow_to_color(u, v, max_mag=None):
    """Dense-flow color encoding (HSV wheel): hue = direction,
    saturation = magnitude, value = 1. The standard Middlebury-style
    visualization for dense fields where quiver subsampling hides
    structure; returns (H, W, 3) float RGB in [0, 1]."""
    import matplotlib.colors as mcolors

    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    mag = np.hypot(u, v)
    if max_mag is None:
        max_mag = max(float(np.percentile(mag, 99)), 1e-6)
    hue = (np.arctan2(-v, -u) / np.pi + 1.0) / 2.0
    sat = np.clip(mag / max_mag, 0.0, 1.0)
    hsv = np.stack([hue, sat, np.ones_like(hue)], axis=-1)
    return mcolors.hsv_to_rgb(hsv)


def color_plot(u, v, title, output_path, max_mag=None):
    """Save the dense color-wheel rendering of a flow field."""
    plt = _plt()
    rgb = flow_to_color(u, v, max_mag)
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(rgb)
    ax.set_title(title)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(output_path, dpi=110)
    plt.close(fig)
    return output_path


def quiver_plot(u, v, title, output_path, subsample_step=8, scale=10.0):
    """Subsampled quiver plot colored by magnitude (reference:
    optical_flow_verifier.py:394-452)."""
    plt = _plt()
    u = np.asarray(u)
    v = np.asarray(v)
    h, w = u.shape
    ys, xs = np.mgrid[subsample_step:h:subsample_step, subsample_step:w:subsample_step]
    us = u[subsample_step:h:subsample_step, subsample_step:w:subsample_step]
    vs = v[subsample_step:h:subsample_step, subsample_step:w:subsample_step]
    mag = np.sqrt(us**2 + vs**2)

    fig, ax = plt.subplots(figsize=(12, 9))
    q = ax.quiver(
        xs, ys, us, vs, mag,
        angles="xy", scale_units="xy", scale=1.0 / scale, cmap="jet", width=0.003,
    )
    ax.set_aspect("equal")
    ax.set_xlim(0, w)
    ax.set_ylim(h, 0)
    ax.set_title(title)
    ax.set_xlabel("X (pixels)")
    ax.set_ylabel("Y (pixels)")
    plt.colorbar(q, ax=ax, label="Flow Magnitude (pixels)")
    plt.tight_layout()
    plt.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def error_heatmap(u, v, u_true, v_true, title, output_path, vmax=5.0):
    """Heatmap of per-pixel endpoint error (reference:
    optical_flow_verifier.py:455-493)."""
    plt = _plt()
    err = np.sqrt((np.asarray(u) - u_true) ** 2 + (np.asarray(v) - v_true) ** 2)
    fig, ax = plt.subplots(figsize=(12, 9))
    im = ax.imshow(err, cmap="hot", vmin=0, vmax=vmax, interpolation="nearest")
    ax.set_title(title)
    ax.set_aspect("equal")
    plt.colorbar(im, ax=ax, label="Error Magnitude (pixels)")
    plt.tight_layout()
    plt.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def diagnostic_panel(u, v, output_path, title="Flow Diagnostic",
                     compare_uv=None, subsample_step=8):
    """4-panel diagnostic: quiver / magnitude heatmap / u,v histograms /
    (optional) per-pixel difference vs a second flow field (reference:
    scripts/visualize_flow.py:63-306)."""
    plt = _plt()
    u = np.asarray(u)
    v = np.asarray(v)
    h, w = u.shape
    mag = np.sqrt(u**2 + v**2)

    fig, axes = plt.subplots(2, 2, figsize=(16, 12))
    fig.suptitle(title)

    ys, xs = np.mgrid[subsample_step:h:subsample_step, subsample_step:w:subsample_step]
    us = u[subsample_step:h:subsample_step, subsample_step:w:subsample_step]
    vs = v[subsample_step:h:subsample_step, subsample_step:w:subsample_step]
    axes[0, 0].quiver(xs, ys, us, vs, np.sqrt(us**2 + vs**2),
                      angles="xy", scale_units="xy", cmap="jet", width=0.003)
    axes[0, 0].set_ylim(h, 0)
    axes[0, 0].set_title("Flow field")

    im = axes[0, 1].imshow(mag, cmap="viridis")
    axes[0, 1].set_title("Magnitude")
    plt.colorbar(im, ax=axes[0, 1])

    axes[1, 0].hist(u.ravel(), bins=64, alpha=0.6, label="u")
    axes[1, 0].hist(v.ravel(), bins=64, alpha=0.6, label="v")
    axes[1, 0].legend()
    axes[1, 0].set_title("Component histograms")

    if compare_uv is not None:
        cu, cv = (np.asarray(a) for a in compare_uv)
        diff = np.sqrt((u - cu) ** 2 + (v - cv) ** 2)
        im = axes[1, 1].imshow(diff, cmap="hot")
        axes[1, 1].set_title("Difference vs comparison flow")
        plt.colorbar(im, ax=axes[1, 1])
    else:
        axes[1, 1].axis("off")

    plt.tight_layout()
    plt.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def save_pyramid_levels(levels, out_dir, flow_range=20.0) -> None:
    """Per-pyramid-level flow snapshots: one 3-panel figure per level
    (U / V as signed RdBu_r maps, magnitude as viridis), coarsest first
    (reference: python/lucas_kanade_pyramidal.py:313-352, which writes
    these from inside the solve loop; here the solver returns the
    per-level fields purely via ``return_levels=True``).

    ``levels``: list of (u, v) pairs as returned by
    ``lucas_kanade_pyramidal(..., return_levels=True)``.
    """
    plt = _plt()
    from matplotlib.colors import Normalize

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for level, (u, v) in enumerate(levels):
        u = np.asarray(u)
        v = np.asarray(v)
        mag = np.sqrt(u**2 + v**2)
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        panels = (
            (u, "RdBu_r", Normalize(vmin=-flow_range, vmax=flow_range),
             f"Level {level}: U (horizontal)"),
            (v, "RdBu_r", Normalize(vmin=-flow_range, vmax=flow_range),
             f"Level {level}: V (vertical)"),
            (mag, "viridis", Normalize(vmin=0, vmax=flow_range),
             f"Level {level}: Magnitude"),
        )
        for ax, (data, cmap, norm, title) in zip(axes, panels):
            im = ax.imshow(data, cmap=cmap, norm=norm)
            ax.set_title(title)
            ax.axis("off")
            plt.colorbar(im, ax=ax, label="pixels")
        plt.tight_layout()
        plt.savefig(out / f"pyramid_level_{level}.png", dpi=100,
                    bbox_inches="tight")
        plt.close(fig)


def save_pattern_plots(result: dict, out_dir) -> None:
    """Showcase-pattern plots from a verifier result entry."""
    out = Path(out_dir) / result["pattern_name"]
    out.mkdir(parents=True, exist_ok=True)
    gt = result["ground_truth"]
    for mode in ("single", "pyramidal"):
        u, v = result["flow_fields"][mode]
        quiver_plot(
            u, v,
            f"{result['pattern_name']} - {mode} flow",
            out / f"flow_{mode}.png",
        )
        error_heatmap(
            u, v, gt["u"], gt["v"],
            f"{result['pattern_name']} - {mode} error",
            out / f"error_{mode}.png",
        )


def main(argv: list[str] | None = None) -> None:
    """Diagnostic panel from an ``x y u v`` dump, optional --compare
    against a second dump."""
    import argparse

    from tpuflow_torch.io.frames import load_flow_text

    parser = argparse.ArgumentParser(description="Visualize a flow-field text dump")
    parser.add_argument("flow_file", type=str)
    parser.add_argument("--compare", type=str, default=None,
                        help="Second x-y-u-v dump to difference against")
    parser.add_argument("--output", type=str, default="flow_diagnostic.png")
    parser.add_argument("--color", action="store_true",
                        help="dense HSV color-wheel rendering instead of "
                        "the 4-panel diagnostic")
    parser.add_argument("--title", type=str, default=None)
    args = parser.parse_args(argv)

    for f in filter(None, (args.flow_file, args.compare)):
        if not Path(f).exists():
            raise SystemExit(f"flow dump not found: {f}")
    u, v = load_flow_text(args.flow_file)
    cmp_uv = load_flow_text(args.compare) if args.compare else None
    if args.color:
        color_plot(
            u, v, args.title or Path(args.flow_file).name, args.output
        )
    else:
        diagnostic_panel(
            u, v, args.output,
            title=args.title or Path(args.flow_file).name,
            compare_uv=cmp_uv,
        )
    print(f"Saved: {args.output}")


if __name__ == "__main__":
    main()
