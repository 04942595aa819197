"""The port's HerdNet CSV -> COCO converter
(wildlifemapper_tpu_torch/data/csv_to_coco.py) against the JAX package's
(wildlifemapper_tpu/data/csv_to_coco.py) on the same CSVs and images.

What is compared: the JSON file each writes, byte for byte, apart from the
`date_created` line of its `info` block (the converter stamps the time,
csv_to_coco.py:100-102); and the command lines' refusal of a half-given
default size. Then PIL blocked: the port's module still imports, and the
converter raises the ImportError rather than skipping every image.
"""

import csv
import importlib
import json
import sys

import pytest
from PIL import Image

from wildlifemapper_tpu.data import csv_to_coco as jconv
from wildlifemapper_tpu_torch.data import csv_to_coco as tconv

POINT = ["images", "x", "y", "labels"]
BBOX = ["images", "x_min", "y_min", "x_max", "y_max", "labels"]
ALIAS = ["images", "x1", "y1", "x2", "y2", "labels"]


def _write_csv(path, headers, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(headers)
        w.writerows(rows)
    return str(path)


@pytest.fixture
def images(tmp_path):
    """Three readable images of different sizes, written out of name
    order, and one file that is no image."""
    d = tmp_path / "imgs"
    d.mkdir()
    for name, size in (("c.jpg", (120, 90)), ("a.png", (100, 80)),
                       ("b.jpg", (64, 200))):
        Image.new("RGB", size, (90, 120, 90)).save(d / name)
    (d / "broken.jpg").write_bytes(b"not an image")
    return d


def _without_date(path):
    lines = open(path).read().splitlines()
    dated = [i for i, line in enumerate(lines) if '"date_created"' in line]
    assert len(dated) == 1
    return lines[:dated[0]] + lines[dated[0] + 1:]


def _both(tmp_path, csv_file, images, **kw):
    """Each converter on the same inputs; their files apart from the date,
    and the port's parsed JSON."""
    outs = []
    for tag, mod in (("jax", jconv), ("port", tconv)):
        out = tmp_path / tag / "out.json"
        mod.convert_csv_to_coco(csv_file, str(images), str(out), **kw)
        outs.append(out)
    assert _without_date(outs[1]) == _without_date(outs[0])
    return json.loads(outs[1].read_text())


# (headers, rows, converter keywords): points with an int and a float
# label column, box size 11 (an odd half), points at the edges; boxes
# that leave the image (the pre-clamp area), degenerate boxes; the alias
# headers; rows of an unreadable and of a missing image, with and without
# a default size; rows given out of filename order
CASES = {
    "points": (POINT, [["c.jpg", 50, 40, 2], ["a.png", 98, 3, 5],
                       ["a.png", 1, 79, 2], ["b.jpg", 63.5, 199.0, 3]],
               dict(box_size=11)),
    "points_float_labels": (POINT, [["a.png", 10, 10, 2.5],
                                    ["b.jpg", 30, 30, 1.0]], {}),
    "bbox": (BBOX, [["a.png", 10, 20, 30, 60, 1],
                    ["a.png", 90, 70, 140, 95, 3],
                    ["b.jpg", 5.5, 5.0, 5.5, 4.0, 2],
                    ["c.jpg", -10, -5, 20, 30, 1]], {}),
    "bbox_alias": (ALIAS, [["c.jpg", 1, 2, 30, 40, 4],
                           ["b.jpg", 60, 190, 80, 230, 4]], {}),
    "unreadable_skipped": (POINT, [["broken.jpg", 5, 5, 1],
                                   ["a.png", 50, 40, 2],
                                   ["missing.jpg", 7, 7, 6]], {}),
    "default_size": (BBOX, [["broken.jpg", 5, 5, 50, 60, 1],
                            ["missing.jpg", 700, 10, 900, 30, 2],
                            ["a.png", 50, 40, 60, 50, 1]],
                     dict(default_size=(640, 480))),
    "sorted_order": (POINT, [["c.jpg", 1, 1, 1], ["b.jpg", 2, 2, 1],
                             ["c.jpg", 3, 3, 2], ["a.png", 4, 4, 1]], {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_writes_the_jax_json(tmp_path, images, case):
    headers, rows, kw = CASES[case]
    csv_file = _write_csv(tmp_path / "in.csv", headers, rows)
    coco = _both(tmp_path, csv_file, images, **kw)
    names = [im["file_name"] for im in coco["images"]]
    assert names == sorted(names)
    assert [im["id"] for im in coco["images"]] == list(
        range(1, len(names) + 1))
    if case == "unreadable_skipped":
        assert names == ["a.png"]
    if case == "default_size":
        assert {(im["width"], im["height"]) for im in coco["images"]
                if im["file_name"] != "a.png"} == {(640, 480)}


def test_port_helpers_match_jax():
    for x, y, size in ((20.0, 30.0, 11), (2, 1, 10), (0.5, 7.25, 4)):
        assert tconv.point_to_bbox(x, y, size) == jconv.point_to_bbox(
            x, y, size)
    for box, w, h in (([150.0, 10.0, 10.0, 10.0], 100, 100),
                      ([5.0, 5.0, 0.0, -3.0], 100, 100),
                      ([-4, 99, 300, 300], 64, 100)):
        assert tconv.clamp_bbox(box, w, h) == jconv.clamp_bbox(box, w, h)
    for headers in (POINT, BBOX, ALIAS):
        assert tconv.detect_mode(headers) == jconv.detect_mode(headers)
    with pytest.raises(ValueError, match="Invalid CSV headers"):
        tconv.detect_mode(POINT + ["extra"])
    assert (tconv.POINT_HEADERS, tconv.BBOX_HEADERS,
            tconv.BBOX_ALIAS_HEADERS) == (jconv.POINT_HEADERS,
                                          jconv.BBOX_HEADERS,
                                          jconv.BBOX_ALIAS_HEADERS)


def test_main_takes_the_jax_flags(tmp_path, images, capsys):
    csv_file = _write_csv(tmp_path / "in.csv", POINT,
                          [["broken.jpg", 5, 5, 1], ["a.png", 50, 40, 2]])
    outs = []
    for tag, mod in (("jax", jconv), ("port", tconv)):
        out = str(tmp_path / tag / "out.json")
        mod.main(["--csv_file", csv_file, "--images_dir", str(images),
                  "--output_json", out, "--bbox_size", "12",
                  "--default_width", "320", "--default_height", "240"])
        outs.append(out)
    assert _without_date(outs[1]) == _without_date(outs[0])
    assert "wrote 2 images / 2 annotations" in capsys.readouterr().out
    # a half-given default size is refused by both, before any file
    for mod in (jconv, tconv):
        with pytest.raises(SystemExit):
            mod.main(["--csv_file", csv_file, "--images_dir", str(images),
                      "--output_json", str(tmp_path / "half.json"),
                      "--default_width", "320"])
    assert "must be given together" in capsys.readouterr().err
    assert not (tmp_path / "half.json").exists()


def test_without_pil_the_port_imports_and_the_probe_raises(
        tmp_path, images, monkeypatch):
    """A machine without PIL (the card's): importing the module succeeds,
    and converting raises the ImportError instead of skipping every image
    as unreadable."""
    csv_file = _write_csv(tmp_path / "in.csv", POINT, [["a.png", 5, 5, 1]])
    for name in [m for m in sys.modules if m == "PIL" or
                 m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.delitem(sys.modules, tconv.__name__)
    fresh = importlib.import_module(tconv.__name__)
    assert fresh is not tconv
    with pytest.raises(ImportError):
        fresh.convert_csv_to_coco(csv_file, str(images),
                                  str(tmp_path / "out.json"))
    assert not (tmp_path / "out.json").exists()
