"""The port's ``data/`` copies (csvutil, settings, labels, split) against
the JAX package's: the files each writes byte-equal, the reports and
returned values equal, and `split_dataset` the same split for a seed."""

import os

import pytest
from PIL import Image

from icp_slam_yolo_tpu.data import csvutil as jcsv
from icp_slam_yolo_tpu.data import labels as jlabels
from icp_slam_yolo_tpu.data import settings as jsettings
from icp_slam_yolo_tpu.data import split as jsplit
from icp_slam_yolo_tpu_torch.data import csvutil as tcsv
from icp_slam_yolo_tpu_torch.data import labels as tlabels
from icp_slam_yolo_tpu_torch.data import settings as tsettings
from icp_slam_yolo_tpu_torch.data import split as tsplit


def _tree(root) -> dict:
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("kind", ["tab", "comma"])
def test_delimited_tables_write_the_same_files(kind, tmp_path):
    results = []
    for mod, side in ((jcsv, "j"), (tcsv, "t")):
        path = str(tmp_path / f"{side}.csv")
        table = (mod.tab_table if kind == "tab" else mod.comma_table)(path, header=["stem", "label", "x"])
        table.append(["img1", "pallet", 1.5])
        table.append(["img2", "box, wide", "2"])
        table.append(["img3", "pallet", "3"])
        table.edit_cell(1, 2, "9.25")
        table.delete_row(2)
        results.append((open(path, "rb").read(), table.read_rows(), table.find_rows(1, "pallet"), table.column(0)))
        mod.DelimitedTable(path, ",", header=["ignored"])  # an existing file keeps its rows
        assert table.read_rows() == results[-1][1]
    assert results[0] == results[1]


def test_settings_and_registry_equal_jax(tmp_path):
    text = "# comment\n\nimage_dir  /data/images\nclasses pallet box\nimage_dir /data/other\nlonely\n"
    (tmp_path / "s.txt").write_text(text)
    assert tsettings.read_settings(str(tmp_path / "s.txt")) == jsettings.read_settings(str(tmp_path / "s.txt"))
    for mod, side in ((jsettings, "j"), (tsettings, "t")):
        mod.write_settings(str(tmp_path / side / "w.txt"), {"a": 1, "b": "two words"})
        reg = mod.PathRegistry(str(tmp_path / side / "reg.txt"))
        assert reg.get("missing", "dflt") == "dflt"
        reg.set("labels", "/x/y")
        reg.set("images", "/x/z")
        assert mod.PathRegistry(str(tmp_path / side / "reg.txt")).get("labels") == "/x/y"
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


@pytest.mark.parametrize("fix", [False, True])
def test_check_labels_equal_jax(fix, tmp_path):
    """The reports equal (paths aside) and, with ``fix``, the repaired
    trees byte-equal."""
    for side in ("j", "t"):
        d = tmp_path / side
        (d / "sub").mkdir(parents=True)
        (d / "good.txt").write_text("0 0.5 0.5 0.2 0.2\n")
        (d / "bad.txt").write_text("0 1.5 0.5 0.2 -0.1\n1 0.1 0.2 0.3 0.4\n\n")
        (d / "sub" / "poly.txt").write_text("2 0.1 0.1 1.0000001 0.2 0.5 -0.0001\n")
        (d / "notes.md").write_text("0 5 5\n")
    jr = jlabels.check_labels(str(tmp_path / "j"), fix=fix)
    tr = tlabels.check_labels(str(tmp_path / "t"), fix=fix)
    assert (tr.n_files, tr.n_bad) == (jr.n_files, jr.n_bad) == (3, 2)
    assert [m.replace(str(tmp_path / "t"), "") for m in tr.messages] == [
        m.replace(str(tmp_path / "j"), "") for m in jr.messages]
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    if fix:
        assert tlabels.check_labels(str(tmp_path / "t")).n_bad == 0


def test_label_writers_equal_jax(tmp_path):
    poly = [(0.1, 0.2), (0.3, 0.2), (0.3, 0.4), (0.1, 0.4)]
    objects = [("pallet", (10.0, 20.0, 110.0, 70.0)), ("box", (200.0, 50.0, 260.0, 120.0))]
    for mod, side in ((jlabels, "j"), (tlabels, "t")):
        d = tmp_path / side
        dirs = {k: str(d / k) for k in ("obb", "pose", "object")}
        mod.write_all_formats(dirs, "frame1", 0, poly)
        mod.write_all_formats(dirs, "frame1", 1, poly[::-1])
        mod.write_all_formats({"obb": str(d / "only_obb")}, "frame2", 3, poly)
        mod.write_voc_xml(str(d / "img1.xml"), "img1.jpg", (640, 480), objects)
        mod.write_createml_json(str(d / "anns.json"), [("img1.jpg", objects)])
        mod.write_yolo_txt(str(d / "img1.txt"), (640, 480), objects, ["pallet", "box"])
        assert mod.read_voc_xml(str(d / "img1.xml")) == jlabels.read_voc_xml(str(d / "img1.xml"))
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert tlabels.polygon_to_cxcywh(poly) == jlabels.polygon_to_cxcywh(poly)
    assert tlabels.pose_row(0, (0.5, 0.5, 0.1, 0.1), poly, [2, 1, 0, 2]) == jlabels.pose_row(
        0, (0.5, 0.5, 0.1, 0.1), poly, [2, 1, 0, 2])


@pytest.mark.parametrize("layout", ["nested", "flat"])
@pytest.mark.parametrize("ratio,seed", [(0.8, 42), (0.5, 7), (1.0, 42)])
def test_split_dataset_equals_jax(layout, ratio, seed, tmp_path):
    """The same stems in train and val for a seed (``random.Random(seed)``
    shuffles both), the output trees byte-equal; a stem without a label
    is copied without one, and other files are left out."""
    src = tmp_path / "src"
    img_dir = src / "images" if layout == "nested" else src
    lbl_dir = src / "labels" if layout == "nested" else src
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(exist_ok=True)
    for i in range(11):
        ext = (".jpg", ".png", ".jpeg")[i % 3]
        Image.new("RGB", (8, 8), (i * 20, 0, 0)).save(img_dir / f"img{i}{ext}")
        if i != 4:
            (lbl_dir / f"img{i}.txt").write_text(f"0 0.5 0.5 0.1 0.{i}\n")
    (img_dir / "readme.md").write_text("x")
    got = tsplit.split_dataset(str(src), str(tmp_path / "t"), train_ratio=ratio, seed=seed)
    want = jsplit.split_dataset(str(src), str(tmp_path / "j"), train_ratio=ratio, seed=seed)
    assert got == want == (int(11 * ratio), 11 - int(11 * ratio))
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
