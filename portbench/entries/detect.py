"""The detector over batches of frames: `models.detect.Detector.predict_batch`
on seeded weights handed over as an Ultralytics state dict, each batch's
detections read back before the next batch goes out.

The check: at the sampled calls, the raw head outputs of the forward
(caught by a hook on the head), every image's detections and their decoded
boxes (the share more than a quarter of a stride off, at the anchors the
reference scores clearly) against the plain reference's from the same
frames and weights.
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import judge as J
from portbench.frames import frame_pool
from portbench.harness import Check, Session, sampled_calls
from portbench.reference import yolo
from portbench.weights import ultralytics_state

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_detector(cfg: dict, state: dict, device):
    """The program's detector as the configuration runs it, from an
    Ultralytics state dict through the program's own import."""
    from icp_slam_yolo_tpu_torch.io.torch_import import convert_state_dict, validate_against_model
    from icp_slam_yolo_tpu_torch.models.detect import Detector
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    with torch.random.fork_rng(devices=[]):
        fresh = YOLO(num_classes=cfg["num_classes"], variant=cfg["variant"], family=cfg["family"])
    host = {k: v.detach().cpu() for k, v in state.items()}
    full = validate_against_model(convert_state_dict(host, cfg["family"]), fresh)
    return Detector(num_classes=cfg["num_classes"], variant=cfg["variant"], family=cfg["family"],
                    img_size=cfg["img_size"], conf_threshold=cfg["conf_threshold"],
                    iou_threshold=cfg["iou_threshold"], max_detections=cfg["max_detections"],
                    compute_dtype=_DTYPES[cfg["compute_dtype"]], fold_bn=cfg["fold_bn"],
                    pallas_convs=cfg["fused_convs"], device=device, state_dict=full)


def read_detections(dets) -> torch.Tensor:
    """A batch's detections on the host, one copy: ``(B, K, 8)`` rows
    ``[x1, y1, x2, y2, score, class, valid, anchor]``."""
    return torch.cat([dets.boxes.float(), dets.scores.float()[..., None], dets.classes.float()[..., None],
                      dets.valid.float()[..., None], dets.anchor_idx.float()[..., None]], -1).cpu()


def as_lists(rows: torch.Tensor) -> list[dict]:
    out = []
    for r in rows.double().numpy():
        keep = r[:, 6] > 0.5
        out.append({"boxes": r[keep, :4], "scores": r[keep, 4], "classes": r[keep, 5].astype(int),
                    "anchors": r[keep, 7].astype(int)})
    return out


# what `judge` compares, each with a limit in the cell file
NUMBERS = ("head_gap", "detection_mismatch", "box_mismatch")
BOX_TOL = 0.25  # strides: a box farther than this from the reference's at its anchor is off


class DetectSession(Session):
    kind = "detect"
    rate_metric = "frames_per_s"
    tail_metric = "batch_ms_p95"

    def __init__(self, cell, seed: int, device):
        super().__init__()
        self.cell, self.cfg = cell, cell.config
        self.frames = frame_pool(cell.traffic, self.cfg["img_size"], seed, device)
        calib = self.frames.reshape(-1, *self.frames.shape[2:])[: int(self.cfg["init"]["calibration_frames"])]
        self.state = ultralytics_state(self.cfg, seed, device, calib)
        self.units_per_call = int(self.frames.shape[1])
        self.det = build_detector(self.cfg, self.state, device)
        self.sampled = set(sampled_calls(cell.check, seed))
        self.caught = None
        self.catching = False
        self.det.model.head.register_forward_hook(self._catch)
        self.snaps: dict[int, dict] = {}
        for i in range(int(cell.traffic["warm_calls"])):
            self.call(i)
        self.dispatch_s.clear()

    def _catch(self, module, inputs, output):
        if self.catching:
            self.caught = output

    def batch(self, i: int) -> torch.Tensor:
        return self.frames[i % self.frames.shape[0]]

    def call(self, i: int) -> None:
        t0 = time.perf_counter()
        dets = self.det.predict_batch(self.batch(i))
        self.dispatch_s.append(time.perf_counter() - t0)
        self.answers = read_detections(dets)

    def before(self, i: int, traced: bool = False) -> None:
        self.catching = i in self.sampled

    def after(self, i: int) -> None:
        if self.catching:
            self.snaps[i] = {"frames": i % self.frames.shape[0], "head": self.caught, "answers": self.answers}
        self.catching, self.caught = False, None

    def layer_work(self) -> dict:
        """Forward operations of an image and the conv sites' least time for
        one image, counted on the plain model's shapes: a C2f with one
        bottleneck is one fused block (input, its four weights and output
        each once); every other conv a site of its own."""
        from portbench.spec import PEAK_BF16, PEAK_BYTES

        sites = yolo.site_work(self.cfg, self.cfg["img_size"])
        n_in_block = {}
        for s in sites:
            n_in_block[s["block"]] = n_in_block.get(s["block"], 0) + 1
        least = 0.0
        blocks: dict[str, list] = {}
        for s in sites:
            if s["block"] and n_in_block[s["block"]] == 4:
                blocks.setdefault(s["block"], []).append(s)
            else:
                least += max(s["ops"] / PEAK_BF16, (s["in_bytes"] + s["w_bytes"] + s["out_bytes"]) / PEAK_BYTES)
        for members in blocks.values():
            ops = sum(m["ops"] for m in members)
            nbytes = members[0]["in_bytes"] + sum(m["w_bytes"] for m in members) + members[-1]["out_bytes"]
            least += max(ops / PEAK_BF16, nbytes / PEAK_BYTES)
        return {"forward_ops": yolo.conv_flops(self.cfg, self.cfg["img_size"]), "conv_least_s": least}

    def release(self) -> None:
        self.det = None

    def judge(self, control: bool = False) -> list[Check]:
        """The program's head outputs and detections (``control``: the
        reference's with float8 convs) against the reference's in float32."""
        lim = self.cell.limits
        t0 = time.perf_counter()
        prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            model = yolo.Model(self.cfg, self.state)
            low = yolo.Model(self.cfg, self.state, fp8=True) if control else None
            gap, bad, of, boxes = 0.0, 0, 0, []
            _, strides = yolo.anchors(self.cfg["img_size"], self.frames.device)
            for snap in self.snaps.values():
                images = self.frames[snap["frames"]].permute(0, 3, 1, 2)
                levels = model.forward(images)
                boxes_ref, conf, label = yolo.decode(levels, self.cfg["img_size"], self.cfg["reg_max"])
                ref_dets = yolo.detections(boxes_ref, conf, label, self.cfg)
                if control:
                    got = low.forward(images)
                    dets = yolo.detections(*yolo.decode(got, self.cfg["img_size"], self.cfg["reg_max"]), self.cfg)
                else:
                    got = [(b.permute(0, 3, 1, 2), c.permute(0, 3, 1, 2)) for b, c in snap["head"]]
                    dets = as_lists(snap["answers"])
                gap = max(gap, J.head_gap(got, levels))
                b, f = J.detection_mismatch(dets, conf, ref_dets, self.cfg["conf_threshold"])
                bad, of = bad + b, of + f
                boxes += J.box_gaps(dets, boxes_ref, conf, strides, self.cfg["conf_threshold"])
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        print(f"reference check: {len(self.snaps)} batches, {of} detections, {len(boxes)} boxes at clear anchors "
              f"(median gap {sorted(boxes)[len(boxes) // 2] if boxes else 0.0:.4f} strides), "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        values = {"head_gap": gap, "detection_mismatch": J.share(bad, of),
                  "box_mismatch": J.share(sum(g > BOX_TOL for g in boxes), len(boxes))}
        return [Check(k, float(v), float(lim.get(k, 0.0))) for k, v in values.items()]


def setup(cell, seed: int, device) -> DetectSession:
    return DetectSession(cell, seed, device)
