"""Split-file parsing.

Formats match the reference's ``splits/`` directory:
- multi-view splits: one line per sample,
  ``left.jpg right0.jpg ... rightN.jpg``
  (reference datasets/multi_view_stereo_dataset.py:25-49);
- DeMoN splits: one scene directory name per line
  (reference datasets/demon_dataset.py:34-52).
"""

from __future__ import annotations


def read_multi_view_split(path: str, replace_jpg_with_png: bool = False):
    """Returns (left_names, right_names_lists)."""
    lefts, rights = [], []
    with open(path, "r") as f:
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            lefts.append(tokens[0])
            rights.append(tokens[1:])
    if replace_jpg_with_png:
        lefts = [n.replace(".jpg", ".png") for n in lefts]
        rights = [[n.replace(".jpg", ".png") for n in r] for r in rights]
    return lefts, rights


def read_scene_list(path: str):
    with open(path, "r") as f:
        return [line.strip() for line in f if line.strip()]
