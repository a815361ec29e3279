"""Loss and validation logs in the reference's text formats.

Port of ``multi_view_stereonet_tpu/train/logging.py:25-56``:
- losses.txt: ``epoch batch step loss <key...>`` rows
  (reference multi_view_stereonet_utils.py:30-56);
- validation.txt: ``epoch loss <metric...>`` (reference :58-74).
The loss plots and image galleries are not ported yet (ROADMAP.md M9).
"""

from __future__ import annotations

import os


def _flatten(loss_dict):
    """(keys, float values) of a loss dict; a list value ``k`` becomes ``k0``, ``k1``..."""
    keys, values = [], []
    for k, v in loss_dict.items():
        if isinstance(v, (list, tuple)):
            for i, vv in enumerate(v):
                keys.append(f"{k}{i}")
                values.append(float(vv))
        else:
            keys.append(k)
            values.append(float(v))
    return keys, values


def log_losses(epoch, batch, step, loss, loss_dict, output_file):
    keys, values = _flatten(loss_dict)
    if not os.path.exists(output_file):
        with open(output_file, "w") as f:
            f.write("epoch batch step loss " + " ".join(keys) + " \n")
    with open(output_file, "a") as f:
        f.write(f"{epoch} {batch} {step} {float(loss)} "
                + " ".join(str(v) for v in values) + " \n")


def log_validation_metrics(epoch, loss, metrics, output_file):
    if not os.path.exists(output_file):
        with open(output_file, "w") as f:
            f.write("epoch loss " + " ".join(metrics.keys()) + " \n")
    with open(output_file, "a") as f:
        f.write(f"{epoch} {float(loss)} "
                + " ".join(str(float(v)) for v in metrics.values()) + " \n")
