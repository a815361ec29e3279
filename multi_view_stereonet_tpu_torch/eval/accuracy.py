"""Accuracy at speed: abs_rel, validation EPE, deviation and ms/frame per precision config.

Port of the JAX repository's ladder (``scripts/accuracy_speed.py``). A split is read as
its ``canonical_batches`` reads one (``:22-61``: testing transforms at the run's size,
ground truth loaded, batch 2 in split order); each config of ``CONFIGS`` (the JAX
names and dicts, ``:88-104``) runs the forward over those batches, and is scored by
``abs_rel_over_batches`` (``:64-86``, the GTA depth mask), by the validation EPE (the
train CLI's, ``train/validation.py``), and against the "highest" maps: the JAX
script's max |delta| in % of the range (``:153-166``), and per pyramid level the max and
mean |delta| over the range, held to PERF.md's fast-mode bars. Then ms per frame at B=1,
from CUDA events after warm-up (the JAX script timed a ``fori_loop``, ``:168-180``).

Configs that resolve to the same modes on the card (``resolved_modes``: the dtypes and
every stage's precision but the warp's, which has no matmul) compute the same thing:
their maps must be bit-equal (this raises otherwise), and they are timed once.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from ..data import BatchLoader, GTASfMMultiViewDataset, get_testing_transforms
from ..models import MultiViewStereoNetConfig, mvsnet_forward, resolve_dtypes
from ..models.mvsnet import NUM_LEVELS, resolve_precision
from ..train.pipeline import multi_view_unpack_batch
from ..train.validation import disparity_metrics
from ..utils.timing import device_timer
from .streaming import to_device

CONFIGS = {
    "highest": dict(matmul_precision="highest"),
    "high": dict(matmul_precision="high"),
    "default": dict(),
    "bf16": dict(compute_dtype="bfloat16"),
    "refiners_f32": dict(refiner_dtype="float32"),
    "cost_high": dict(stage_precision=(("cost", "high"),)),
    "refiners_high": dict(stage_precision=(("refiners", "high"),)),
    "extractor_high": dict(stage_precision=(("extractor", "high"),)),
    "chain_high": dict(stage_precision=(("chain", "high"),)),
    "warp_high": dict(stage_precision=(("warp", "high"),)),
    "cost_refiners_high": dict(
        stage_precision=(("cost", "high"), ("refiners", "high"))),
    "all_but_refiners_high": dict(
        stage_precision=(("cost", "high"), ("extractor", "high"),
                         ("chain", "high"), ("warp", "high"))),
}
# Per pyramid level, (max, mean) of |fast - "highest"| over "highest"'s range (PERF.md §2;
# bf16 from docs/PARITY.md:157-160); and the north star's abs_rel bar, the delta against
# "highest" relative to it, for "bf16" and "high" (docs/PARITY.md:157-200).
LEVEL_BARS = {"bf16": (3e-2, 5e-3), "tf32": (1e-2, 2e-3)}
ABS_REL_BAR = 1e-2
ABS_REL_JUDGED = ("bf16", "high")


def split_batches(data_dir: str, split: str, rows: int, cols: int, batch_size: int = 2,
                  workers: int = 2) -> list:
    """A split's samples as ``canonical_batches`` reads them: testing transforms at
    (rows, cols), the ground-truth depthmaps, ``batch_size`` in split order, the last
    batch short; numpy batches without the file names."""
    dataset = GTASfMMultiViewDataset(data_dir, split, 0,
                                     get_testing_transforms({"size": [rows, cols]}),
                                     load_groundtruth_depthmaps=True)
    batches = []
    for batch in BatchLoader(dataset, batch_size=batch_size, shuffle=False,
                             drop_last=False, workers=workers):
        batch.pop("left_filenames")
        batch.pop("right_filenames")
        batches.append(batch)
    return batches


def abs_rel_over_batches(idepth_fn, batches) -> float:
    """Mean per-sample abs_rel over the batches. ``idepth_fn(batch)`` gives numpy (B, H,
    W) idepth in metric units (over the baseline); the GTA depth mask (0 < depth < 1000)
    applies to truth and estimate."""
    rels = []
    for b in batches:
        idepth = idepth_fn(b)
        for i in range(idepth.shape[0]):
            depth_true = b["left_depthmap_true"][i]
            est = np.where(idepth[i] > 0, 1.0 / np.maximum(idepth[i], 1e-9), 0.0)
            mask = (depth_true > 0) & (depth_true < 1e3) & (est > 0) & (est < 1e3)
            rels.append(np.mean(np.abs(depth_true[mask] - est[mask]) / depth_true[mask]))
    return float(np.mean(rels))


def model_config(name: str, **base) -> MultiViewStereoNetConfig:
    """``CONFIGS[name]`` over ``base`` (the run's shapes, e.g. num_idepth_samples)."""
    return MultiViewStereoNetConfig(**{**base, **CONFIGS[name]})


def resolved_modes(config: MultiViewStereoNetConfig) -> tuple:
    """What ``config`` runs: its (compute, refiner, frontend) dtypes, its ambient
    precision mode and each stage's but the warp's (K1 interpolates without a matmul and
    is exact at every precision, ``resolve_precision``)."""
    ambient, modes = resolve_precision(config)
    return (resolve_dtypes(config), ambient,
            tuple((stage, mode) for stage, mode in modes.items() if stage != "warp"))


def mode_class(config: MultiViewStereoNetConfig) -> str:
    """"bf16" where any dtype is bf16, "tf32" where any stage runs at TF32, else
    "exact"."""
    dtypes, ambient, modes = resolved_modes(config)
    if torch.bfloat16 in dtypes:
        return "bf16"
    return "tf32" if "tf32" in {ambient, *(m for _, m in modes)} else "exact"


def forward_maps(model, batch: dict, config, device) -> tuple:
    """(refined pyramid over the baseline as numpy, level 0 first; the batch's EPE)."""
    with torch.inference_mode():
        inputs = multi_view_unpack_batch(to_device(batch, device), NUM_LEVELS)
        out = mvsnet_forward(model, inputs["left_image_pyr"], inputs["K_pyr"],
                             inputs["T_right_in_left"], inputs["right_image_pyr"], config)
        epe = disparity_metrics(inputs["K_pyr"][0], inputs["T_right_in_left"][:, 0],
                                out["left_idepthmap_pyr"][0],
                                inputs["left_idepthmap_true"])["epe"]
        scale = inputs["baseline"][:, None, None]
        levels = [(lvl.float() / scale).cpu().numpy() for lvl in out["left_idepthmap_pyr"]]
    return levels, float(epe)


def ms_per_frame(model, batch: dict, config, device, runs: int = 20,
                 warmup: int = 3) -> float:
    """Median ms of one forward of a B=1 batch already on the card, CUDA events around
    each (``device_timer``) after ``warmup`` forwards."""
    if batch[next(iter(batch))].shape[0] != 1:
        raise ValueError("ms per frame is timed at B=1")
    tensors = to_device(batch, device)
    with torch.inference_mode():
        inputs = multi_view_unpack_batch(tensors, NUM_LEVELS)

        def forward():
            mvsnet_forward(model, inputs["left_image_pyr"], inputs["K_pyr"],
                           inputs["T_right_in_left"], inputs["right_image_pyr"], config)
        for _ in range(warmup):
            forward()
        times = []
        for _ in range(runs):
            with device_timer(device) as timer:
                forward()
            times.append(timer.ms)
    return statistics.median(times)


def deviation(maps: list, ref: list) -> tuple:
    """(the JAX script's max |delta| in % of the range, per batch at level 0; per level
    (max, mean) of |delta| over the range, all batches together). A constant reference
    (dead refiners) gives inf or NaN, as in the JAX script."""
    with np.errstate(divide="ignore", invalid="ignore"):
        max_dev = max(float(np.abs(m[0] - r[0]).max() / np.float64(r[0].max() - r[0].min())
                            * 100.0) for m, r in zip(maps, ref))
        levels = []
        for lvl in range(NUM_LEVELS):
            got = np.concatenate([m[lvl] for m in maps]).astype(np.float64)
            want = np.concatenate([r[lvl] for r in ref]).astype(np.float64)
            span = want.max() - want.min()
            delta = np.abs(got - want)
            levels.append((float(delta.max() / span), float(delta.mean() / span)))
    return max_dev, levels


def ladder(model, batches: list, device, names=None, base=None, time_batch=None,
           log=print) -> dict:
    """{name: row} over ``names`` (every config, "highest" first, by default): abs_rel,
    its delta against "highest" in %, EPE, the deviations, the bars, and ms per frame of
    ``time_batch`` (B=1, on a card; None elsewhere: not measured). A config that
    resolves to an earlier one's modes must give bit-equal maps (AssertionError
    otherwise) and takes its time (``timed_as``)."""
    device = torch.device(device)
    names = list(CONFIGS) if names is None else list(names)
    if "highest" in names:
        names.remove("highest")
        names.insert(0, "highest")
    base = base or {}
    rows, first_by_modes, maps_by_name = {}, {}, {}
    for name in names:
        config = model_config(name, **base)
        maps, epes = zip(*(forward_maps(model, b, config, device) for b in batches))
        it = iter(maps)
        row = {"abs_rel": abs_rel_over_batches(lambda b: next(it)[0], batches),
               "epe": float(np.mean(epes)), "class": mode_class(config)}
        key = resolved_modes(config)
        same = first_by_modes.get(key)
        if same is not None:
            equal = all(np.array_equal(a, b) for m, r in zip(maps, maps_by_name[same])
                        for a, b in zip(m, r))
            if not equal:
                raise AssertionError(f"{name} resolves to {same}'s modes and its maps are "
                                     "not bit-equal to them")
            row.update(same_modes_as=same, bit_equal=True, ms=rows[same]["ms"],
                       timed_as=same)
        else:
            first_by_modes[key] = name
            row.update(same_modes_as=None, timed_as=name, ms=(
                ms_per_frame(model, time_batch, config, device)
                if time_batch is not None and device.type == "cuda"
                else None))
        maps_by_name[name] = maps
        if "highest" in maps_by_name:
            ref = rows.get("highest", row)["abs_rel"]
            row["abs_rel_delta_pct"] = 100.0 * (row["abs_rel"] - ref) / ref
            row["max_dev_pct"], row["levels"] = deviation(maps, maps_by_name["highest"])
            row.update(judge(name, row))
        rows[name] = row
        log(format_row(name, row))
    return rows


def judge(name: str, row: dict) -> dict:
    """The bars a row is held to: per level (max, mean) for its mode class, and for
    "bf16" and "high" the abs_rel delta. A row at "highest"'s modes has none."""
    out = {}
    if row["class"] in LEVEL_BARS:
        max_bar, mean_bar = LEVEL_BARS[row["class"]]
        out["levels_met"] = all(m <= max_bar and a <= mean_bar for m, a in row["levels"])
    if name in ABS_REL_JUDGED:
        out["abs_rel_met"] = abs(row["abs_rel_delta_pct"]) <= 100.0 * ABS_REL_BAR
    return out


def format_row(name: str, row: dict) -> str:
    ms = "not measured" if row["ms"] is None else f"{row['ms']:.3f}"
    text = f"{name:24s} abs_rel {row['abs_rel']:.6f} epe {row['epe']:.4f} ms/frame {ms}"
    if "abs_rel_delta_pct" in row:
        text += (f" delta {row['abs_rel_delta_pct']:+.4f}% max_dev "
                 f"{row['max_dev_pct']:.4f}%")
    if row["same_modes_as"]:
        text += f" (bit-equal to {row['same_modes_as']})"
    return text


def markdown_table(rows: dict) -> str:
    """The ladder as a markdown table: one row a config."""
    lines = ["| config | abs_rel | Δ vs highest | EPE (px) | max dev (% range, level 0) "
             "| per level max / mean (% range), levels 0-4 | bars | ms/frame B=1 |",
             "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    for name, row in rows.items():
        levels = ("—" if "levels" not in row else
                  ", ".join(f"{100 * m:.3f} / {100 * a:.4f}" for m, a in row["levels"]))
        if row["same_modes_as"]:
            bars = f"bit-equal to {row['same_modes_as']}"
        else:
            bars = "; ".join(f"{k[:-4].replace('_', ' ')} {'met' if v else 'MISSED'}"
                             for k, v in row.items() if k.endswith("_met")) or "—"
        ms = ("not measured" if row["ms"] is None else
              f"{row['ms']:.3f}" + (f" (as {row['timed_as']})"
                                    if row["timed_as"] != name else ""))
        delta = (f"{row['abs_rel_delta_pct']:+.4f}%" if "abs_rel_delta_pct" in row else "—")
        max_dev = f"{row['max_dev_pct']:.4f}" if "max_dev_pct" in row else "—"
        lines.append(f"| {name} | {row['abs_rel']:.6f} | {delta} | {row['epe']:.4f} | "
                     f"{max_dev} | {levels} | {bars} | {ms} |")
    return "\n".join(lines) + "\n"
