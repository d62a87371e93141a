"""YOLO label validation and repair; a copy of the JAX package's
``data/labels.py`` (`check_labels.py:4-63` parity).

Scans ``*.txt`` label files for coordinates outside [0, 1]; with ``fix=True``
clamps offending values and rewrites the file (same clamp-and-rewrite repair
as the reference).  Also provides the reference labeler's multi-format label
writers (`labels_segmentation.py:61-139`): OBB polygon, pose (bbox +
keypoints + visibility) and plain object (cxcywh) rows.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class LabelReport:
    n_files: int
    n_bad: int
    messages: list[str]


def check_labels(directory: str, fix: bool = False) -> LabelReport:
    messages: list[str] = []
    n_files = 0
    n_bad = 0
    for root, _, files in os.walk(directory):
        for name in sorted(files):
            if not name.endswith(".txt"):
                continue
            path = os.path.join(root, name)
            n_files += 1
            fixed_lines = []
            bad = False
            with open(path) as f:
                for ln, line in enumerate(f, 1):
                    vals = line.split()
                    if not vals:
                        continue
                    cls, coords = vals[0], [float(v) for v in vals[1:]]
                    out = [c for c in coords if c < 0.0 or c > 1.0]
                    if out:
                        bad = True
                        messages.append(f"{path}:{ln}: {len(out)} coord(s) outside [0,1]")
                        coords = [min(max(c, 0.0), 1.0) for c in coords]
                    fixed_lines.append(" ".join([cls] + [f"{c:.6f}" for c in coords]))
            if bad:
                n_bad += 1
                if fix:
                    with open(path, "w") as f:
                        f.write("\n".join(fixed_lines) + "\n")
    return LabelReport(n_files=n_files, n_bad=n_bad, messages=messages)


# --- LabelImg export formats (the vendored `labelImg.py` writes Pascal VOC
# --- XML, YOLO txt and CreateML JSON) -----------------------------------------

def write_voc_xml(path: str, image_name: str, img_size, objects) -> None:
    """Pascal VOC annotation XML.  ``objects``: [(name, (x1, y1, x2, y2)), ...]."""
    import xml.etree.ElementTree as ET

    w, h = img_size
    root = ET.Element("annotation")
    ET.SubElement(root, "filename").text = image_name
    size = ET.SubElement(root, "size")
    ET.SubElement(size, "width").text = str(w)
    ET.SubElement(size, "height").text = str(h)
    ET.SubElement(size, "depth").text = "3"
    for name, (x1, y1, x2, y2) in objects:
        obj = ET.SubElement(root, "object")
        ET.SubElement(obj, "name").text = name
        ET.SubElement(obj, "pose").text = "Unspecified"
        ET.SubElement(obj, "truncated").text = "0"
        ET.SubElement(obj, "difficult").text = "0"
        box = ET.SubElement(obj, "bndbox")
        ET.SubElement(box, "xmin").text = str(int(x1))
        ET.SubElement(box, "ymin").text = str(int(y1))
        ET.SubElement(box, "xmax").text = str(int(x2))
        ET.SubElement(box, "ymax").text = str(int(y2))
    ET.ElementTree(root).write(path)


def read_voc_xml(path: str):
    """Inverse of `write_voc_xml`: returns (image_name, (w, h), objects)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    size = root.find("size")
    dims = (int(size.find("width").text), int(size.find("height").text))
    objects = []
    for obj in root.findall("object"):
        b = obj.find("bndbox")
        objects.append(
            (obj.find("name").text,
             (float(b.find("xmin").text), float(b.find("ymin").text),
              float(b.find("xmax").text), float(b.find("ymax").text)))
        )
    return root.findtext("filename"), dims, objects


def write_createml_json(path: str, entries) -> None:
    """CreateML annotation JSON.  ``entries``: [(image_name, [(label, (x1,y1,x2,y2)), ...]), ...]
    (CreateML stores centre + size)."""
    import json

    payload = []
    for image_name, objects in entries:
        anns = []
        for label, (x1, y1, x2, y2) in objects:
            anns.append({
                "label": label,
                "coordinates": {
                    "x": (x1 + x2) / 2, "y": (y1 + y2) / 2,
                    "width": x2 - x1, "height": y2 - y1,
                },
            })
        payload.append({"image": image_name, "annotations": anns})
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def write_yolo_txt(path: str, img_size, objects, class_names) -> None:
    """YOLO txt: ``class cx cy w h`` normalised.  ``objects`` as in VOC writer."""
    w, h = img_size
    with open(path, "w") as f:
        for name, (x1, y1, x2, y2) in objects:
            cls = class_names.index(name)
            f.write(object_row(cls, ((x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
                                     (x2 - x1) / w, (y2 - y1) / h)) + "\n")


# --- label writers (three formats at once, `labels_segmentation.py:61-139`) --

def polygon_row(cls: int, points_norm) -> str:
    """OBB/segmentation polygon: ``class x1 y1 x2 y2 ...`` normalised."""
    flat = " ".join(f"{v:.6f}" for xy in points_norm for v in xy)
    return f"{cls} {flat}"


def pose_row(cls: int, cxcywh_norm, keypoints_norm, visibility) -> str:
    """Pose: ``class cx cy w h kx1 ky1 v1 ...`` (`labels_segmentation.py:107-112`)."""
    box = " ".join(f"{v:.6f}" for v in cxcywh_norm)
    kps = " ".join(
        f"{x:.6f} {y:.6f} {int(v)}" for (x, y), v in zip(keypoints_norm, visibility)
    )
    return f"{cls} {box} {kps}"


def object_row(cls: int, cxcywh_norm) -> str:
    """Plain detect: ``class cx cy w h`` (`labels_segmentation.py:127-129`)."""
    return f"{cls} " + " ".join(f"{v:.6f}" for v in cxcywh_norm)


def polygon_to_cxcywh(points_norm):
    xs = [p[0] for p in points_norm]
    ys = [p[1] for p in points_norm]
    return (
        (min(xs) + max(xs)) / 2,
        (min(ys) + max(ys)) / 2,
        max(xs) - min(xs),
        max(ys) - min(ys),
    )


def write_all_formats(base_dirs: dict, stem: str, cls: int, points_norm) -> None:
    """Write one object into the three output trees the labeler maintains
    (`output/`, `output_pose/`, `output_oject/` in the reference)."""
    cxcywh = polygon_to_cxcywh(points_norm)
    rows = {
        "obb": polygon_row(cls, points_norm),
        "pose": pose_row(cls, cxcywh, points_norm, [2] * len(points_norm)),
        "object": object_row(cls, cxcywh),
    }
    for kind, row in rows.items():
        d = base_dirs.get(kind)
        if d is None:
            continue
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, stem + ".txt"), "a") as f:
            f.write(row + "\n")
