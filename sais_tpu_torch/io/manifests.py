"""Path manifests: the reference's CSVs (generate_paths.py).

Own copy of `sais_tpu/io/manifests.py` without pandas:
<dataset>_Paths.csv (path / category / label a frame, :21-38) and
<dataset>_FlowPaths.csv (frame pairs jump_frames apart with the derived
flowpath, :40-69), written byte for byte as pandas' `to_csv` writes them
there (an unnamed index column first, '\\n' line ends, minimal quoting).
Only tools of the reference read them; the pipeline passes arrays in
memory.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence

Row = Dict[str, str]


def _frame_files(casepath: str) -> List[str]:
    """The sorted frame images of a case directory (stray entries such as
    .DS_Store or partial .tmp writes left out)."""
    return sorted(f for f in os.listdir(casepath)
                  if f.lower().endswith((".jpg", ".jpeg", ".png")))


def frame_paths_manifest(root: str, videos: Sequence[str],
                         images_dir: str = "images") -> List[Row]:
    return [{"path": os.path.join(images_dir, case, f), "category": case,
             "label": case}
            for case in videos
            for f in _frame_files(os.path.join(root, images_dir, case))]


def flow_paths_manifest(root: str, videos: Sequence[str],
                        jump_frames: int = 15,
                        images_dir: str = "images") -> List[Row]:
    """Frame pairs (path1, path2) jump_frames apart and the flowpath.

    Pair starts are range(0, nframes - jump, jump) over the sorted file
    list; path2 is made from the frame number in the name
    (generate_paths.py:47-54), flowpath = flows_<frame // jump>.jpg
    (:64-69)."""
    rows = []
    for case in videos:
        files = _frame_files(os.path.join(root, images_dir, case))
        for i in range(0, len(files) - jump_frames, jump_frames):
            stem, ext = os.path.splitext(files[i])
            frame = int(stem.split("_")[-1])
            rows.append({
                "path1": os.path.join(images_dir, case, files[i]),
                "path2": os.path.join(images_dir, case,
                                      f"frames_{frame + jump_frames:08d}"
                                      f"{ext}"),
                "category": case, "label": case,
                "flowpath": os.path.join("flows", case,
                                         f"flows_{frame // jump_frames:08d}"
                                         ".jpg")})
    return rows


def write_rows_csv(rows: Sequence[Row], dest: str) -> None:
    """`pd.DataFrame(rows).to_csv(dest)`: a header with an empty first
    cell, then one line a row led by its 0-based index; no rows and no
    columns give the single line '""'."""
    with open(dest, "w", newline="") as f:
        if not rows:
            f.write('""\n')
            return
        w = csv.writer(f, lineterminator="\n")
        cols = list(rows[0])
        w.writerow(["", *cols])
        for i, r in enumerate(rows):
            w.writerow([i, *(r[c] for c in cols)])


def write_manifests(root: str, videos: Sequence[str],
                    dataset: str = "Custom") -> None:
    """<dataset>_Paths.csv and <dataset>_FlowPaths.csv under <root>/paths."""
    out = os.path.join(root, "paths")
    os.makedirs(out, exist_ok=True)
    write_rows_csv(frame_paths_manifest(root, videos),
                   os.path.join(out, f"{dataset}_Paths.csv"))
    write_rows_csv(flow_paths_manifest(root, videos),
                   os.path.join(out, f"{dataset}_FlowPaths.csv"))
