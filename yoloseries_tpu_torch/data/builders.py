"""Dataset builders: COCO / VOC -> the folder-of-images + txt-label layout;
counterpart of ``yoloseries_tpu/data/builders.py`` (plain Python: json and
ElementTree, no pycocotools, no lxml). Output layout:

    out/img/<name>.jpg       (symlink or copy of the source image)
    out/lab/<name>.txt       lines: "class_id xmin ymin xmax ymax"
    out/names.txt            lines: "class_id name"
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

__all__ = ["build_coco_dataset", "build_voc_dataset"]


def _place_image(src: Path, dst: Path, link: bool):
    if dst.exists():
        return
    if link:
        dst.symlink_to(src.resolve())
    else:
        shutil.copyfile(src, dst)


def build_coco_dataset(ann_json, img_src_dir, out_dir, link_images=True,
                       skip_crowd=True):
    """Convert a COCO instances JSON + image dir into the txt layout.

    Category ids are remapped to contiguous [0, nc) in category-id order
    (COCO's 80 classes have gaps). Returns (num_images, num_boxes).
    """
    ann_json = Path(ann_json)
    img_src_dir = Path(img_src_dir)
    out_dir = Path(out_dir)
    img_dir = out_dir / "img"
    lab_dir = out_dir / "lab"
    img_dir.mkdir(parents=True, exist_ok=True)
    lab_dir.mkdir(parents=True, exist_ok=True)

    coco = json.loads(ann_json.read_text())
    cats = sorted(coco["categories"], key=lambda c: c["id"])
    cat2idx = {c["id"]: i for i, c in enumerate(cats)}
    (out_dir / "names.txt").write_text(
        "".join(f"{i} {c['name']}\n" for i, c in enumerate(cats))
    )

    images = {im["id"]: im for im in coco["images"]}
    per_image: dict[int, list[str]] = {im_id: [] for im_id in images}
    n_boxes = 0
    for ann in coco["annotations"]:
        if skip_crowd and ann.get("iscrowd", 0):
            continue
        x, y, w, h = ann["bbox"]  # COCO xywh (top-left)
        if w < 1 or h < 1:
            continue
        cls = cat2idx[ann["category_id"]]
        per_image[ann["image_id"]].append(
            f"{cls} {x:.2f} {y:.2f} {x + w:.2f} {y + h:.2f}"
        )
        n_boxes += 1

    n_images = 0
    for im_id, im in images.items():
        src = img_src_dir / im["file_name"]
        if not src.exists():
            continue
        stem = Path(im["file_name"]).stem
        _place_image(src, img_dir / Path(im["file_name"]).name, link_images)
        (lab_dir / f"{stem}.txt").write_text(
            "\n".join(per_image[im_id]) + ("\n" if per_image[im_id] else "")
        )
        n_images += 1
    return n_images, n_boxes


def build_voc_dataset(voc_root, out_dir, split="trainval", year=None,
                      link_images=True):
    """Convert a VOCdevkit layout (Annotations/*.xml + JPEGImages) into the
    txt layout. Returns (num_images, num_boxes)."""
    from xml.etree import ElementTree

    voc_root = Path(voc_root)
    out_dir = Path(out_dir)
    img_dir = out_dir / "img"
    lab_dir = out_dir / "lab"
    img_dir.mkdir(parents=True, exist_ok=True)
    lab_dir.mkdir(parents=True, exist_ok=True)

    ann_dir = voc_root / "Annotations"
    jpg_dir = voc_root / "JPEGImages"
    split_file = voc_root / "ImageSets" / "Main" / f"{split}.txt"
    if split_file.exists():
        stems = split_file.read_text().split()
    else:
        stems = [p.stem for p in ann_dir.glob("*.xml")]

    names: dict[str, int] = {}
    n_images = n_boxes = 0
    for stem in stems:
        xml_path = ann_dir / f"{stem}.xml"
        jpg_path = jpg_dir / f"{stem}.jpg"
        if not xml_path.exists() or not jpg_path.exists():
            continue
        root = ElementTree.parse(xml_path).getroot()
        lines = []
        for obj in root.iter("object"):
            name = obj.findtext("name")
            if name not in names:
                names[name] = len(names)
            box = obj.find("bndbox")
            x1 = float(box.findtext("xmin"))
            y1 = float(box.findtext("ymin"))
            x2 = float(box.findtext("xmax"))
            y2 = float(box.findtext("ymax"))
            lines.append(f"{names[name]} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f}")
            n_boxes += 1
        _place_image(jpg_path, img_dir / jpg_path.name, link_images)
        (lab_dir / f"{stem}.txt").write_text(
            "\n".join(lines) + ("\n" if lines else "")
        )
        n_images += 1

    (out_dir / "names.txt").write_text(
        "".join(f"{i} {n}\n" for n, i in sorted(names.items(), key=lambda kv: kv[1]))
    )
    return n_images, n_boxes
