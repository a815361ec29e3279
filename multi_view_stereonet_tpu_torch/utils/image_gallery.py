"""Static HTML image galleries.

Copy of ``multi_view_stereonet_tpu/utils/image_gallery.py`` (reference
utils/image_gallery.py:10-96): a simple grid gallery over a directory of
images, and a "training gallery" with one row per image id across epochs.
"""

from __future__ import annotations

import glob
import os

_EXTS = (".jpg", ".jpeg", ".png")


def _images_in(directory):
    files = []
    for ext in _EXTS:
        files.extend(glob.glob(os.path.join(directory, "*" + ext)))
    return sorted(os.path.basename(f) for f in files)


def create_simple_gallery(directory: str, columns: int = 4,
                          output_name: str = "index.html"):
    """Grid gallery of every image in ``directory``."""
    images = _images_in(directory)
    rows = ['<html><body><table border="0">']
    for i in range(0, len(images), columns):
        cells = "".join(
            f'<td><a href="{n}"><img src="{n}" width="320"/></a><br/>{n}</td>'
            for n in images[i:i + columns])
        rows.append(f"<tr>{cells}</tr>")
    rows.append("</table></body></html>")
    with open(os.path.join(directory, output_name), "w") as f:
        f.write("\n".join(rows))


def create_training_gallery(directory: str, output_name: str = "index.html"):
    """One row per image id, columns = training epochs (file pattern
    ``<id>_<epoch>.jpg`` plus ``<id>_left_input.jpg`` etc)."""
    images = _images_in(directory)
    by_id: dict = {}
    for name in images:
        stem = os.path.splitext(name)[0]
        parts = stem.split("_", 1)
        by_id.setdefault(parts[0], []).append(name)
    rows = ['<html><body><table border="0">']
    for image_id in sorted(by_id):
        cells = "".join(
            f'<td><a href="{n}"><img src="{n}" width="240"/></a><br/>{n}</td>'
            for n in sorted(by_id[image_id]))
        rows.append(f"<tr>{cells}</tr>")
    rows.append("</table></body></html>")
    with open(os.path.join(directory, output_name), "w") as f:
        f.write("\n".join(rows))


def main():
    import argparse

    parser = argparse.ArgumentParser(description="Create an HTML gallery.")
    parser.add_argument("directory")
    parser.add_argument("--columns", type=int, default=4)
    parser.add_argument("--training", action="store_true")
    args = parser.parse_args()
    if args.training:
        create_training_gallery(args.directory)
    else:
        create_simple_gallery(args.directory, args.columns)


if __name__ == "__main__":
    main()
