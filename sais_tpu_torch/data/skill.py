"""VUA_EASE skill-assessment data pipeline: stitch annotations ->
balanced fold splits with per-frame importance targets.

Own copy of `sais_tpu/data/skill.py` without pandas: a table is a list of
row dicts (`data.datasets`), and each function returns the rows pandas
returns there, in the same order.  It replicates the reference's VUA_EASE
VideoDataset branch (prepare_dataset.py:63-426) and its getData sampling
(:2150-2290):

- RACE/EASE metric pairing filter (RaceAndEaseFilter, :168-182);
- segment duration filter (durFilterFunc, :148-161);
- fold-seeded 0.9/0.1 video split (obtain_train_val_split, :259-305 —
  note the fractions differ from the gesture datasets' 0.7/0.2);
- class balancing to the minority `maj` count (balance_scores, :183-191);
- explanation-annotation merge producing per-frame importance targets for
  low-skill rows (loadExplanations/returnFrameIndices/getFrameImportance/
  getImportance, :65-146);
- multi-task '+'-joined domains with the second domain's labels offset
  by +2 (:408-416 and :2156-2158);
- per-video fps tables driving the flow jump size (fps_dict,
  prepare_dataset.py:24-26; jump = fps // 2, :2245).

All of it runs on the host; the card sees only the padded batches that
`collate_skill` makes.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, \
    Tuple

import numpy as np

from sais_tpu_torch.config import (FLOW_JUMP_BY_PHASE, HMH_FPS_TABLE,
                                   VUA_FPS_TABLE)
from sais_tpu_torch.data.collate import BUCKETS, bucket_for
from sais_tpu_torch.data.datasets import (NAN, CachingStore, Row,
                                          balance_classes, batched_indices,
                                          columns_of, concat_rows, isna,
                                          merge_rows)
from sais_tpu_torch.data.tasks import (AFB_HANDLING_POLICY, RACE_POLICIES,
                                       STITCH_INFERENCE_POLICIES,
                                       STITCH_TRAIN_POLICIES,
                                       STITCH_USC_POLICY, SamplingPolicy,
                                       policy_indices, race_window)

# RACE abbreviation -> (RACE annotation name, EASE metric) pairing
# (RaceAndEaseFilter, prepare_dataset.py:168-182)
RACE_EASE_PAIRS = {
    "NW": ("Needle Withdrawal", "Wrist Rotation"),
    "NH": ("Needle Handling", "# Repositions"),
    "ND": ("Needle Driving", "Driving Sequence"),
}

# RACE -> (start column, end column) (returnFrameIndices / getData,
# prepare_dataset.py:80-89, 2161-2171)
RACE_FRAME_COLUMNS = {
    "Needle Withdrawal": ("Needle Withdrawal Start Frame",
                          "Needle Withdrawal End Frame"),
    "Needle Handling": ("Needle Handling Start Frame",
                        "Needle Entry Start Frame"),
    "Needle Driving": ("Needle Entry Start Frame",
                       "Needle Withdrawal Start Frame"),
}

HIGH_SKILL = 2  # 'maj' value denoting high skill (getImportance, :130)


def video_name(path: str) -> str:
    """The Video column the reference derives from a stitch row's Path."""
    return path.split("\\")[-1] if "\\" in path else path.split("/")[-1]


def with_video(rows: Sequence[Row]) -> List[Row]:
    """Rows with a Video column, derived from Path where the table has
    none (prepare_dataset.py:63-64)."""
    if not rows or "Video" in rows[0]:
        return list(rows)
    return [dict(r, Video=video_name(r["Path"])) for r in rows]


def race_and_ease_filter(rows: Sequence[Row], race_abbrev: str) -> List[Row]:
    """Keep rows whose RACE phase and EASE metric match the domain
    (RaceAndEaseFilter, prepare_dataset.py:168-182)."""
    race, ease = RACE_EASE_PAIRS[race_abbrev]
    return [r for r in rows if r["RACE"] == race and r["EASE"] == ease]


def _long_enough(row: Row) -> bool:
    race = row["RACE"]
    if race == "Needle Handling":
        return (row["Needle Entry Start Frame"]
                - row["Needle Handling Start Frame"]) > 20
    if race == "Needle Withdrawal":
        return (row["Needle Withdrawal End Frame"]
                - row["Needle Withdrawal Start Frame"]) > 80
    diff = (row["Needle Withdrawal Start Frame"]
            - row["Needle Entry Start Frame"])
    return diff > int(diff * 0.20)


def duration_filter(rows: Sequence[Row]) -> List[Row]:
    """durFilterFunc (prepare_dataset.py:148-161): drop segments too short
    for their RACE-specific sampling policy."""
    return [r for r in rows if _long_enough(r)]


def ease_video_split(rows: Sequence[Row], fold: int
                     ) -> Tuple[List[Row], List[Row], List[Row]]:
    """Fold-seeded video split (obtain_train_val_split, prepare_dataset.py
    :268-280): 0.9 of videos to train, 0.1 of those to val, rest test —
    python-random call sequence reproduced exactly."""
    cases = list(dict.fromkeys(r["Video"] for r in rows))
    rng = random.Random(fold)
    train_cases = rng.sample(cases, int(0.9 * len(cases)))
    val_cases = rng.sample(train_cases, int(0.1 * len(train_cases)))
    train_cases = set(train_cases) - set(val_cases)
    test_cases = set(cases) - train_cases - set(val_cases)
    return tuple([r for r in rows if r["Video"] in chosen]
                 for chosen in (train_cases, set(val_cases), test_cases))


# ---------------------------------------------------------------------------
# Explanations -> per-frame importance targets
# ---------------------------------------------------------------------------

def load_explanations(frames: Sequence[Sequence[Row]], domain: str,
                      hospital: str = "USC") -> List[Row]:
    """loadExplanations (prepare_dataset.py:65-77): concat the annotation
    tables, filter to the domain's suturing phase + hospital, rename
    'File Number' -> 'File' for merging."""
    rows = concat_rows(frames)
    phase = domain.split("_")[0]
    return [{k.replace("File Number", "File"): v for k, v in r.items()}
            for r in rows
            if r["Suturing Phase"] == phase and r["Hospital"] == hospital]


def explanation_frame_indices(race: str, start_frame, end_frame
                              ) -> np.ndarray:
    """returnFrameIndices (prepare_dataset.py:79-111): sampling grid in
    FRAME-NUMBER space (no -1), reset to start at 0 so it lines up with the
    relative spans in the explanation annotations."""
    if race == "Needle Withdrawal":
        jump = int((end_frame - start_frame) // 10)
        idx = np.arange(start_frame, end_frame, jump)
    else:  # Needle Handling / Needle Driving: drop final 20%, stride 10
        diff = end_frame - start_frame
        drop = int(diff * 0.20)
        idx = np.arange(start_frame, end_frame - drop, 10)
    return idx - start_frame


def frame_importance(rel_indices: np.ndarray,
                     spans: Sequence[Tuple[float, float]]) -> List[int]:
    """getFrameImportance (prepare_dataset.py:113-126): 1 iff the frame
    number falls inside any annotated explanation span (a NaN span
    compares False)."""
    out = []
    for fr in rel_indices:
        imp = 0
        for s, e in spans:
            if s <= fr <= e:
                imp = 1
                break
        out.append(imp)
    return out


def attach_importance(df_train: Sequence[Row], explain: Sequence[Row],
                      nspans: int = 6) -> List[Row]:
    """getImportance (prepare_dataset.py:128-146): merge low-skill rows with
    their explanation annotations and compute the per-frame target list in
    a 'frame importance' column; high-skill rows pass through without one.

    As pandas does it: each low row once per matching explanation row (a
    left merge on File / Stitch, after 'CaseID' -> 'File' in the low rows'
    column names), then an outer merge of high and low rows on every column
    they share, which sorts the rows by those columns and adds '_merge'.
    pandas raises where there is no low-skill row, and so does this."""
    cols = columns_of(df_train)
    low = [r for r in df_train if r["maj"] != HIGH_SKILL]
    high = [r for r in df_train if r["maj"] == HIGH_SKILL]
    if not low:
        # pandas assigns apply's empty frame to one column and raises
        raise ValueError("attach_importance: no low-skill rows to merge "
                         "explanations into")

    def renamed(row: Row) -> Row:
        out = {k.replace("CaseID", "File"): v for k, v in row.items()}
        start, end = RACE_FRAME_COLUMNS[row["RACE"]]
        out["frame indices"] = explanation_frame_indices(
            row["RACE"], row[start], row[end])
        return out

    low = merge_rows([renamed(r) for r in low], explain, ["File", "Stitch"])
    low = [r for r in low if not isna(r["frame indices"])]
    for r in low:
        # a low row no explanation matches has NaN spans: all zeros
        spans = [(r.get(f"Start{n} Frame", NAN), r.get(f"End{n} Frame", NAN))
                 for n in range(1, nspans + 1)]
        r["frame importance"] = frame_importance(r["frame indices"], spans)
    low_cols = columns_of(low)
    common = [c for c in cols if c in low_cols]
    return merge_rows(high, low, common, "outer", indicator=True,
                      left_columns=cols, right_columns=low_cols)


# ---------------------------------------------------------------------------
# Dataset assembly (get_train_val_data_one_domain, prepare_dataset.py:385-416)
# ---------------------------------------------------------------------------

def build_ease_dataset(stitch_rows: Sequence[Row], domain: str, fold: int,
                       balance: bool = True,
                       explanations: Optional[Sequence[Sequence[Row]]] = None,
                       importance_loss: bool = False,
                       exclude_files: Sequence[int] = (102, 372),
                       meta: Optional[Sequence[Row]] = None,
                       group: Optional[str] = None,
                       group_val: Optional[str] = None
                       ) -> Tuple[Dict[str, List[Row]], List[int]]:
    """stitch_rows: VUA_EASE_Stitch_Paths.csv-schema rows.

    Returns ({'train','val','test'} -> rows with Domain + optional
    'frame importance') and the sorted class labels (LabelEncoder order).
    Multi-task '+' domains concatenate per-domain tables; the label offset
    for the second domain (prepare_dataset.py:2156-2158) is applied by
    `encode_skill_label` at collate time.
    """
    excluded = set(exclude_files)
    rows = with_video([r for r in stitch_rows if r["File"] not in excluded])

    def one_domain(dom: str) -> Dict[str, List[Row]]:
        race = dom.split("_")[0]
        maj_labels = [int(c) for c in dom.split("_")[1]]
        sub = race_and_ease_filter(duration_filter(rows), race)
        sub = [r for r in sub if r["maj"] in maj_labels]
        tr, va, te = ease_video_split(sub, fold)
        if balance and meta is not None and group is not None:
            # -bg group balancing / single-group restriction of the train
            # split BEFORE importance + class balancing
            # (obtain_train_val_split, prepare_dataset.py:281-291)
            from sais_tpu_torch.data.reference_datasets import (
                balance_groups, single_group)
            if group_val is not None:
                tr = single_group(tr, meta, group, group_val)
            else:
                tr = balance_groups(tr, meta, group)
        if importance_loss:
            if explanations is None:
                raise ValueError("importance_loss requires explanation CSVs")
            tr = attach_importance(tr, load_explanations(explanations, dom))

        def _bal(part: List[Row]) -> List[Row]:
            # balance_scores samples each present class down to the minority
            # count (prepare_dataset.py:183-191; value_counts().min() only
            # sees present classes)
            present = [m for m in maj_labels
                       if any(r["maj"] == m for r in part)]
            return balance_classes(part, "maj", present) if part else part

        if balance:
            tr = _bal(tr)
        va = _bal(va)
        te = _bal(te)
        return {phase: [dict(r, Domain=dom) for r in part]
                for phase, part in (("train", tr), ("val", va),
                                    ("test", te))}

    domains = domain.split("+") if "+" in domain else [domain]
    data: Dict[str, List[Row]] = {p: [] for p in ("train", "val", "test")}
    classes: List[int] = []
    for dom in domains:
        per = one_domain(dom)
        for phase in data:
            data[phase] = concat_rows((data[phase], per[phase]))
        # QUIRK PRESERVED: the returned classes are the LAST '+'-joined
        # domain's label set — the reference refits self.label_encoder
        # inside its per-domain loop (prepare_dataset.py:398 within
        # get_train_val_data_one_domain, looped at :413-418), so getData
        # transforms BOTH domains' rows with the last domain's encoder.
        classes = sorted(set(int(c) for c in dom.split("_")[1]))
    return data, classes


def encode_skill_label(maj: int, row_domain: str, domain: str,
                       classes: Sequence[int]) -> int:
    """LabelEncoder.transform + the multi-task +2 offset for the second
    '+'-joined domain (prepare_dataset.py:2154-2158)."""
    label = list(classes).index(int(maj))
    if "+" in domain and row_domain == domain.split("+")[1]:
        label += 2
    return label


# ---------------------------------------------------------------------------
# Collation (getData VUA_EASE branch, prepare_dataset.py:2150-2290)
# ---------------------------------------------------------------------------

def _skill_policy(race: str, phase: str, branch: str = "ease"
                  ) -> SamplingPolicy:
    """Sampling policy for one segment.

    branch='ease' (VUA_EASE skill, prepare_dataset.py:2173-2214): the RACE
    windows, with the AFB_inference Needle-Handling stride-120 low-pass
    (:2184-2188).  branch='stitch' (VUA_EASE_Stitch sub-phase,
    :2307-2355): DIFFERENT windows — NW samples around the withdrawal
    START, NH trims a fixed 20 frames in train/val/test, inference drops
    nothing, USC_inference is a plain full-span stride-10 grid."""
    if branch == "stitch":
        if phase == "USC_inference":
            return STITCH_USC_POLICY
        if "inference" in phase:
            return STITCH_INFERENCE_POLICIES[race]
        return STITCH_TRAIN_POLICIES[race]
    if phase == "AFB_inference" and race == "Needle Handling":
        return AFB_HANDLING_POLICY
    return RACE_POLICIES[race]


def skill_segment_indices(row: Row, phase: str, tta_offset: int = 0,
                          branch: str = "ease") -> np.ndarray:
    """Rep-space sampling indices for one stitch segment."""
    race = row["RACE"]
    cols = RACE_FRAME_COLUMNS[race]
    s, e = race_window(int(row[cols[0]]), int(row[cols[1]]), race)
    return policy_indices(s, e, _skill_policy(race, phase, branch),
                          tta_offset)


_STALE_JUMP_PHASES = ("COH_inference", "Gronau_full_inference",
                      "USC_inference")


def _flow_jump(videoname: str,
               fps_table: Mapping[str, float] = VUA_FPS_TABLE,
               phase: str = "",
               rgb_stride: Optional[int] = None) -> int:
    """Flow jump factor (prepare_dataset.py:2239-2249): fixed 15 for
    Gronau inference, fixed 30 for Lab/AFB, HMH per-video fps // 2
    (HMH_FPS_TABLE = extract_representations.py:437-463); for inference
    phases with NO branch (COH / Gronau_full / USC) the reference's
    jump_size variable keeps its STALE RGB-sampling value — a quirk, but
    the flow stores were generated to match it — so the row's RGB stride
    is reused; otherwise the VUA per-video table (fps_dict,
    prepare_dataset.py:24-26), which raises KeyError for unknown videos
    exactly like the reference's fps_dict['VUA'][videoname]."""
    if phase in FLOW_JUMP_BY_PHASE:
        return FLOW_JUMP_BY_PHASE[phase]
    if "HMH" in phase:
        if str(videoname) not in HMH_FPS_TABLE:
            raise KeyError(
                f"video {videoname!r} not in HMH_FPS_TABLE (config.py) — "
                "the reference fails the same way; add the video's fps")
        return int(HMH_FPS_TABLE[str(videoname)] // 2)
    if phase in _STALE_JUMP_PHASES or ("inference" in phase
                                       and rgb_stride is not None):
        if rgb_stride is None:
            raise ValueError(f"phase {phase!r} reuses the RGB stride as "
                             "the flow jump; pass rgb_stride")
        return max(int(rgb_stride), 1)
    if str(videoname) not in fps_table:
        raise KeyError(
            f"video {videoname!r} not in the VUA fps table "
            "(config.VUA_FPS_TABLE) — the reference's "
            "fps_dict['VUA'][videoname] fails the same way; pass an "
            "explicit fps_table or extend the config table")
    return int(fps_table[str(videoname)] // 2)


def _pad(arrays: Sequence[np.ndarray], bucket: int, d: int
         ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, 1, bucket, d) f32 features and (B, 1, bucket + 1) pad mask."""
    x = np.zeros((len(arrays), 1, bucket, d), np.float32)
    mask = np.zeros((len(arrays), 1, bucket + 1), bool)
    for i, arr in enumerate(arrays):
        x[i, 0, :len(arr)] = arr
        mask[i, 0, len(arr) + 1:] = True
    return x, mask


def collate_skill(rows: Sequence[Row], rgb_store, flow_store,
                  classes: Sequence[int], domain: str, phase: str,
                  importance_loss: bool = False,
                  buckets: Sequence[int] = BUCKETS,
                  tta_offset: int = 0,
                  fps_table: Mapping[str, float] = VUA_FPS_TABLE,
                  label_fn=None, branch: str = "ease"
                  ) -> Dict[str, np.ndarray]:
    """One padded batch for PrototypeTrainer from stitch rows.

    Includes per-frame importance targets + ipad mask for `-il` training
    (calcImportanceLoss consumes (B, S, F) targets against (B, S, F+1)
    pad masks, prepare_miscellaneous.py:48-60).  Unlike the gesture path,
    skill flow indices are NOT bounds-clipped (the reference has no clip in
    this branch; out-of-range indices raise, matching torch).
    """
    rgb_list, imp_list, cols, flow_list = [], [], [], []
    for row in rows:
        idx = skill_segment_indices(row, phase, tta_offset, branch)
        reps = rgb_store.read_video(str(row["Video"]))
        rgb_list.append(reps[idx])
        # label_fn overrides the maj-score encoding (e.g. the stitch
        # sub-phase branch labels by EASE domain, prepare_dataset.py:511)
        label = (label_fn(row) if label_fn is not None
                 else encode_skill_label(int(row["maj"]),
                                         row.get("Domain", domain),
                                         domain, classes))
        cols.append(label)
        if (importance_loss and phase == "train" and label == 0
                and isinstance(row.get("frame importance"),
                               (list, np.ndarray))):
            imp_list.append(np.asarray(row["frame importance"], np.float32))
        else:
            imp_list.append(np.zeros((len(idx),), np.float32))
        if flow_store is not None:
            stride = int(idx[1] - idx[0]) if len(idx) > 1 else 1
            jump = _flow_jump(row["Video"], fps_table, phase,
                              rgb_stride=stride)
            fidx = np.unique(idx // jump)
            flow_list.append(flow_store.read_video(str(row["Video"]))[fidx])

    d = rgb_list[0].shape[1]
    fb = bucket_for(max(len(a) for a in rgb_list), buckets)
    rgb, rgb_mask = _pad(rgb_list, fb, d)
    imp = np.zeros((len(rows), 1, fb), np.float32)
    for i, (arr, im) in enumerate(zip(rgb_list, imp_list)):
        n = arr.shape[0]
        imp[i, 0, :min(len(im), n)] = im[:n]
    batch = {
        "rgb": rgb, "rgb_mask": rgb_mask,
        "labels": np.asarray(cols, np.int32),
        "label_cols": np.asarray(cols, np.int32),
        "importance": imp, "ipad": rgb_mask.copy(),
    }
    if "+" in domain:
        # multi-task: rows of the FIRST domain project through `linear`,
        # the second through `linearB` (prepare_model.py:406-416, where the
        # first '+'-joined domain is hardcoded as 'NH_02')
        first = domain.split("+")[0]
        batch["primary_domain"] = np.asarray(
            [row.get("Domain", domain) == first for row in rows], bool)
    if flow_list:
        fmax = bucket_for(max(f.shape[0] for f in flow_list),
                          [2, 4, 8, *buckets])
        batch["flow"], batch["flow_mask"] = _pad(flow_list, fmax, d)
    return batch


def skill_batches(phase_rows: Sequence[Row], rgb_store, flow_store,
                  classes: Sequence[int], domain: str, phase: str,
                  batch_size: int, shuffle: bool,
                  importance_loss: bool = False, seed: int = 0,
                  tta: bool = False,
                  fps_table: Mapping[str, float] = VUA_FPS_TABLE,
                  label_fn=None, branch: str = "ease"
                  ) -> Iterator[Dict[str, Any]]:
    """Yield skill batches; with tta=True each yield carries the 3 TTA
    variants (dict-of-3 semantics of pad_collate,
    prepare_dataset.py:2808-2935) under a 'tta' key."""
    offsets = (0, 3, 6) if tta else (0,)
    for idx in batched_indices(len(phase_rows), batch_size, shuffle, seed):
        rows = [phase_rows[i] for i in idx]
        # one read per distinct video per batch, shared by all TTA variants
        rgb_c = CachingStore(rgb_store)
        flow_c = CachingStore(flow_store) if flow_store is not None else None
        variants = [
            collate_skill(rows, rgb_c, flow_c, classes, domain,
                          phase, importance_loss, tta_offset=off,
                          fps_table=fps_table, label_fn=label_fn,
                          branch=branch)
            for off in offsets
        ]
        out = dict(variants[0])
        if tta:
            out["tta"] = variants
        yield out


# ---------------------------------------------------------------------------
# Hospital-generalization inference phase tables (prepare_dataset.py:304-380)
# ---------------------------------------------------------------------------

EASE_INFERENCE_PHASES = (
    "Gronau_inference", "Gronau_full_inference", "COH_inference",
    "HMH_inference", "Lab_inference", "AFB_inference", "USC_inference")


def _sample(rows: Sequence[Row], n: int, random_state: int = 0
            ) -> List[Row]:
    """DataFrame.sample(n, replace=False, random_state)."""
    if n > len(rows):
        raise ValueError("Cannot take a larger sample than population when "
                         "'replace=False'")
    return [rows[i] for i in np.random.RandomState(random_state).permutation(
        len(rows))[:n]]


def _remap_maj(rows: Sequence[Row]) -> List[Row]:
    """maj.map({0: 0, 1: 0, 2: 2}): another value becomes NaN, and then
    the whole column is float, as pandas types it."""
    mapping = {0: 0, 1: 0, 2: 2}
    values = [mapping.get(r["maj"], NAN) if not isna(r["maj"]) else NAN
              for r in rows]
    if any(isna(v) for v in values):
        values = [float(v) for v in values]
    return [dict(r, maj=v) for r, v in zip(rows, values)]


def ease_inference_table(stitch_rows: Sequence[Row], phase: str,
                         domain: str,
                         videos_available: Optional[Sequence[str]] = None
                         ) -> List[Row]:
    """Build the single-phase row table the reference's VUA_EASE branch
    uses for cross-hospital inference ('inference' in phase,
    prepare_dataset.py:304-380).

    Common preamble for every phase: derive Video from Path, restrict to
    videos present in the feature store, RACE/EASE pairing filter for the
    domain's race, then remap maj {0: 0, 1: 0, 2: 2} ("to increase number
    of negative cases", :332).  Phase-specific selection:

    - Gronau_full_inference: every row, no further filters — and the one
      phase that leaves the Domain column unset (:334-336);
    - Lab_inference: every row (:337-339);
    - AFB_inference: class-balanced to the minority maj count over
      [0, 2] (balance_scores, :340-345);
    - USC_inference: drop Files 102/372 and 'P-' videonames, duration
      filter (:346-353);
    - Gronau/COH/HMH_inference (default): sample exactly 5 high-skill
      rows per video (random_state=0; a video with fewer than 5 raises,
      as upstream), keep all low-skill rows, then balance classes in
      maj-appearance order [2, 0] (:354-377).

    Rows keep every key of their input row (maj remapped), so a caller can
    carry a label of its own through the selection.
    """
    race = domain.split("_")[0]
    rows = with_video(stitch_rows) if stitch_rows and "Path" in \
        stitch_rows[0] else list(stitch_rows)
    if videos_available is not None:
        keep = set(videos_available)
        rows = [r for r in rows if r["Video"] in keep]
    rows = _remap_maj(race_and_ease_filter(rows, race))
    if phase == "Gronau_full_inference":
        return rows
    if phase == "Lab_inference":
        out = rows
    elif phase == "AFB_inference":
        out = balance_classes(rows, "maj", [0, 2])
    elif phase == "USC_inference":
        rows = [r for r in rows if r["File"] not in (102, 372)
                and not (isinstance(r["videoname"], str)
                         and "P-" in r["videoname"])]
        out = duration_filter(rows)
    else:   # Gronau_inference / COH_inference / HMH_inference
        high = [r for r in rows if r["maj"] == 2]
        low = [r for r in rows if r["maj"] == 0]
        both = []
        for pid in dict.fromkeys(r["Video"] for r in high):
            both += _sample([r for r in high if r["Video"] == pid], 5)
        both += low
        out = balance_classes(both, "maj",
                              list(dict.fromkeys(r["maj"] for r in both)))
    return [dict(r, Domain=domain) for r in out]
