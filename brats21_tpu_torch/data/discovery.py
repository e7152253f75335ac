"""Dataset discovery: patient directories → modality path maps.

Semantics of reference utils/files.py:147-230: walk sorted patient dirs,
match ``*_{mod}.nii*`` by last-underscore suffix, warn-and-skip incomplete
patients, order modalities by the required list.
"""

from __future__ import annotations

import glob
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from .. import get_logger

logger = get_logger("data")

MODALITIES = ("t1", "t1ce", "flair", "t2")
MODALITIES_WITH_SEG = ("t1", "t1ce", "flair", "t2", "seg")


def split_filename(path: str) -> Tuple[str, str, str]:
    """(dirname, stem-without-.nii/.nii.gz, extension)."""
    dirname = os.path.dirname(path)
    base = os.path.basename(path)
    for ext in (".nii.gz", ".nii"):
        if base.endswith(ext):
            return dirname, base[: -len(ext)], ext
    stem, ext = os.path.splitext(base)
    return dirname, stem, ext


def create_database(input_dir: str, filter_keyword: Optional[str] = None,
                    filtering_patient: Optional[List[str]] = None,
                    required_modality: Sequence[str] = MODALITIES,
                    keep_going: bool = True) -> "OrderedDict[str, Dict[str, str]]":
    """{patient_id: {modality: path}} over sorted patient dirs
    (files.py:147-190)."""
    patient_dict: "OrderedDict[str, Dict[str, str]]" = OrderedDict()
    for directory in sorted(os.listdir(input_dir)):
        full_dir = os.path.join(input_dir, directory)
        if not os.path.isdir(full_dir):
            continue
        native_image: Dict[str, str] = {}
        found = []
        for file in glob.glob(os.path.join(full_dir, "**", "*.nii*"), recursive=True):
            _, fnm, _ = split_filename(file)
            if filter_keyword is not None and filter_keyword not in fnm:
                continue
            if filtering_patient is not None and any(x in file for x in filtering_patient):
                continue
            modality = fnm.split("_")[-1]
            if modality in required_modality:
                found.append(modality)
                native_image[modality] = file
        if not all(m in found for m in required_modality):
            if not keep_going:
                raise ValueError(f"The patient {directory} has missing modalities; "
                                 f"found: {found}")
            logger.warning("Skipping patient %s: missing modalities (found %s)",
                           directory, found)
            continue
        patient_dict[directory] = native_image
    return OrderedDict(
        (k, {m: v[m] for m in required_modality}) for k, v in patient_dict.items())


def create_database_test_docker(input_dir: str,
                                filter_keyword: Optional[str] = None,
                                filtering_patient: Optional[List[str]] = None,
                                required_modality: Sequence[str] = MODALITIES,
                                ) -> "OrderedDict[str, Dict[str, str]]":
    """Single flat case dir variant (files.py:193-230): one patient whose id
    is the common filename prefix."""
    native_image: Dict[str, str] = {}
    name = ""
    for file in glob.glob(os.path.join(input_dir, "**", "*.nii*"), recursive=True):
        _, fnm, _ = split_filename(file)
        if filter_keyword is not None and filter_keyword not in fnm:
            continue
        if filtering_patient is not None and any(x in file for x in filtering_patient):
            continue
        modality = fnm.split("_")[-1]
        if modality in required_modality:
            name = "_".join(fnm.split("_")[:-1])
            native_image[modality] = file
    return OrderedDict(
        {name: {m: native_image[m] for m in required_modality}})


def make_file_records(database: "OrderedDict[str, Dict[str, str]]",
                      with_seg: bool) -> List[Dict]:
    """[{patient_id, img: [4 paths], seg: path?}] (definer.py:600-621,643)."""
    records = []
    for ptid, mods in database.items():
        paths = list(mods.values())
        rec = {"patient_id": ptid}
        if with_seg:
            rec["img"] = paths[:-1]
            rec["seg"] = paths[-1]
        else:
            rec["img"] = paths
        records.append(rec)
    return records

