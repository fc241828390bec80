"""Patient-index alignment and label mapping (port of
`ecgmm_tpu/data/align.py`, over `sources.Table`): the reference's cohort
construction (dataset.py:126-162) drops unmapped labels ('Borderline' in
the binary task), maps the rest to ints, intersects the patient indices of
the four sources and removes the known-missing image folders.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Set, Tuple

import numpy as np

from ecgmm_torch.data.sources import Table

# the canonical binary task (reference dataset.py:134)
LABEL_MAP_BINARY = {"Normal": 0, "Abnormal": 1}
# the AF task (reference train_signal_only_af.py:81-82)
LABEL_MAP_AF = {"Abnormal": 0, "AF": 1, "Borderline": 0}
# the arrhythmia task (reference train_signal_only_arr.py:84-86)
LABEL_MAP_ARR = {"Abnormal": 0, "Arrhythmia": 1}


def filter_and_map_labels(labels: Table,
                          label_map: Dict[str, int] = LABEL_MAP_BINARY,
                          drop: Sequence[str] = ()) -> Table:
    """Map the `label` column through `label_map`, dropping the labels it
    lacks and those in `drop`; `index` becomes int64 and the row index a
    range again (reference dataset.py:133-134)."""
    names = labels["label"]
    keep = np.asarray([lab not in drop and lab in label_map
                       for lab in names], bool)
    out = labels.rows(keep).reset_index()
    out["label"] = np.asarray([label_map[lab] for lab in names[keep]],
                              np.int64)
    out["index"] = out["index"].astype(np.int64)
    return out


def intersect_indices(label_indices: Iterable[int],
                      ecg_indices: Iterable[int],
                      clinical_indices: Iterable[int],
                      image_indices: Optional[Iterable[int]] = None,
                      known_missing: Iterable[int] = ()) -> Set[int]:
    """The patients in every source, less the known-missing image folders
    (reference dataset.py:144-158)."""
    common = set(map(int, label_indices)) & set(map(int, ecg_indices)) \
        & set(map(int, clinical_indices))
    if image_indices is not None:
        common &= set(map(int, image_indices)) - set(map(int, known_missing))
    return common


def _isin(values: np.ndarray, common: Set[int]) -> np.ndarray:
    return np.asarray([int(v) in common for v in values], bool)


def align_frames(labels: Table, ecg: Table, clinical: Table,
                 common: Set[int]) -> Tuple[Table, Table, Table]:
    """Restrict the three tables to `common`, each in its own row order
    (reference dataset.py:160-162): the labels and the clinical table by
    their `index` column (row index reset), the signals by their index."""
    return (labels.rows(_isin(labels["index"], common)).reset_index(),
            ecg.rows(_isin(ecg.index, common)),
            clinical.rows(_isin(clinical["index"], common)).reset_index())
