"""The published YOLO12 over batches of frames: `models.detect.Detector.
predict_batch` with ``family="yolo12"``, on seeded weights handed over as
an Ultralytics state dict, each batch's detections read back before the next
batch goes out.  A ``detect`` session, so the ``detect.batch`` root and the
detector's readers apply.

The check is `entries.detect`'s: at the sampled calls, the raw head
outputs, the detections and their decoded boxes against the plain
reference (`reference.yolo12`, float32) from the same frames and weights;
besides, ``b4_gap``: the output of the stride-16 attention stage (the
program's ``b4``, Ultralytics' layer 6: its eight area-attention blocks),
caught by a hook like the head's, against the reference's.  There the
bf16 rounding has passed through 7 layers, not the head's 21, so the gap is
small enough to tell a wrong band split.  The control is the reference with
its convs and attention products in float8.

Only the frames that bfloat16 resolves are compared (`Yolo12Session.
_resolved`): on a few frames of some seeds the seeded net's attention is
one-hot and a perturbation of the frame by bfloat16's rounding moves the
float32 reference's own head by a large part of its spread, so no program
in that precision could match it there.  ``unresolved_share``, the share
left out, is read from the reference alone, the same for the program and
the control, and its limit keeps at least a quarter of the frames compared.

Weights follow `weights.py`'s laws over `reference.yolo12.state_layout`,
with each residual ``A2C2f``'s ``gamma`` at the configuration's ``gamma``;
the DFL projection is Ultralytics' frozen ``arange``.
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import judge as J
from portbench.entries.detect import BOX_TOL, DetectSession, as_lists, build_detector
from portbench.frames import frame_pool
from portbench.harness import Check, Session, sampled_calls
from portbench.reference import yolo, yolo12

CHUNK = 8  # images a reference forward takes at once
# what `judge` compares, each with a limit in the cell file
NUMBERS = ("head_gap", "b4_gap", "detection_mismatch", "box_mismatch", "unresolved_share")
# what bfloat16 can resolve: a frame perturbed by bfloat16's rounding (2^-9 of
# itself) whose float32 reference head outputs move by more than RESOLVE_TOL of
# their spread is one that rounding alone decides, in any program
RESOLVE_NOISE, RESOLVE_TOL = 2.0 ** -9, 0.05
STAGE16 = 6  # Ultralytics' index of the stride-16 attention stage, the program's ``b4``


def yolo12_state(cfg: dict, seed: int, device, frames: torch.Tensor | None = None) -> dict:
    """``{key: float32 tensor}`` for every tensor of the model's state dict;
    with ``frames`` (NHWC), the BatchNorm statistics are calibrated on them
    (`reference.yolo12.calibrate`)."""
    layout = yolo12.state_layout(cfg["variant"], cfg["num_classes"], cfg["reg_max"])
    init = cfg["init"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63 ^ 0x5DEECE66D)
    sizes = [torch.Size(s).numel() for _, s in layout]
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for (key, shape), n in zip(layout, sizes):
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if key.endswith("dfl.conv.weight"):
            out[key] = torch.arange(shape[1], dtype=torch.float32, device=device).view(shape)
        elif key.endswith(".weight") and len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            gain = init["gain"]
            if ".cv2." in key and key.endswith(".2.weight"):
                gain = init["box_out_gain"]
            elif ".cv3." in key and key.endswith(".2.weight"):
                gain = init["class_out_gain"]
            z = z - z.mean(dim=(1, 2, 3), keepdim=True)
            out[key] = z * (gain / fan_in ** 0.5)
        elif key.endswith("bn.weight"):
            lo, hi = init["bn_scale"]
            out[key] = lo + (hi - lo) * u
        elif key.endswith("bn.running_var"):
            out[key] = 0.5 + 1.5 * u
        elif key.endswith("bn.bias") or key.endswith("bn.running_mean"):
            out[key] = 0.1 * z
        elif key.endswith("gamma"):
            out[key] = torch.full(shape, float(init["gamma"]), device=device)
        elif ".cv3." in key:  # class branch output bias
            out[key] = torch.full(shape, float(init["class_bias"]), device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    if frames is not None:
        out = yolo12.calibrate(cfg, out, frames.permute(0, 3, 1, 2))
    return out


def feature_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """A feature map's root-mean-square gap over the standard deviation of
    the reference's (infinite where the shapes differ)."""
    if got.shape != ref.shape:
        return float("inf")
    ref = ref.to(torch.float64)
    return float(torch.sqrt(((got.to(torch.float64) - ref) ** 2).mean()) / torch.clamp(ref.std(), min=1e-12))


class Yolo12Session(DetectSession):
    def __init__(self, cell, seed: int, device):
        Session.__init__(self)
        self.cell, self.cfg, self.seed = cell, cell.config, seed
        self.frames = frame_pool(cell.traffic, self.cfg["img_size"], seed, device)
        calib = self.frames.reshape(-1, *self.frames.shape[2:])[: int(self.cfg["init"]["calibration_frames"])]
        self.state = yolo12_state(self.cfg, seed, device, calib)
        self.units_per_call = int(self.frames.shape[1])
        self.det = build_detector(self.cfg, self.state, device)
        self.sampled = set(sampled_calls(cell.check, seed))
        self.caught = None
        self.catching = False
        self.det.model.head.register_forward_hook(self._catch)
        self.caught_b4 = None
        self.det.model.b4.register_forward_hook(self._catch_b4)
        self.snaps: dict[int, dict] = {}
        for i in range(int(cell.traffic["warm_calls"])):
            self.call(i)
        self.dispatch_s.clear()

    def _catch_b4(self, module, inputs, output):
        if self.catching:
            self.caught_b4 = output

    def after(self, i: int) -> None:
        if self.catching:
            self.snaps[i] = {"frames": i % self.frames.shape[0], "head": self.caught, "answers": self.answers,
                             "b4": self.caught_b4}
        self.catching, self.caught, self.caught_b4 = False, None, None

    def layer_work(self) -> dict:
        """An image's forward operations (convs and attention products), the
        least time of the conv sites the fused kernels run (each its own
        launch: bf16 operations at the peak, or input, weights and output
        once at the memory rate) and of the attention products (operations
        at the peak, or q, k, v and the output once)."""
        from portbench.spec import PEAK_BF16, PEAK_BYTES

        size = self.cfg["img_size"]
        sites, attn = yolo12.site_work(self.cfg, size), yolo12.attention_work(self.cfg, size)
        conv_least = sum(max(s["ops"] / PEAK_BF16, (s["in_bytes"] + s["w_bytes"] + s["out_bytes"]) / PEAK_BYTES)
                         for s in sites if s["kernel"])
        attn_least = sum(max(a["ops"] / PEAK_BF16, a["bytes"] / PEAK_BYTES) for a in attn)
        return {"forward_ops": yolo12.conv_flops(self.cfg, size) + sum(a["ops"] for a in attn),
                "conv_least_s": conv_least, "attn_least_s": attn_least}

    def _levels(self, model, images):
        """The reference's head outputs over ``images`` (NCHW), CHUNK images
        at a time, and its stride-16 attention stage's output."""
        parts, stage = [], []
        for i in range(0, images.shape[0], CHUNK):
            parts.append(model.forward(images[i:i + CHUNK], keep=(STAGE16,)))
            stage.append(model.kept.pop(STAGE16))
        levels = [tuple(torch.cat([p[lvl][j] for p in parts]) for j in range(2)) for lvl in range(len(parts[0]))]
        return levels, torch.cat(stage)

    def _resolved(self, model, images, levels, key: int) -> torch.Tensor:
        """``(B,)`` bool: the frames the configuration's precision resolves,
        the float32 reference's head outputs moving by at most RESOLVE_TOL of
        their spread when the frame is perturbed by RESOLVE_NOISE of itself
        (seeded by the run's seed and the call)."""
        gen = torch.Generator(device=images.device)
        gen.manual_seed((int(self.seed) * 1_000_003 + key) % 2**63)
        noise = torch.randn(images.shape, generator=gen, device=images.device)
        moved, _ = self._levels(model, images * (1 + RESOLVE_NOISE * noise))
        worst = torch.zeros(images.shape[0], dtype=torch.float64, device=images.device)
        for pair_a, pair_b in zip(levels, moved):
            for a, b in zip(pair_a, pair_b):
                a, b = a.to(torch.float64).flatten(1), b.to(torch.float64).flatten(1)
                worst = torch.maximum(worst, ((b - a) ** 2).mean(1).sqrt() / a.std(1).clamp(min=1e-12))
        return (worst <= RESOLVE_TOL).cpu()

    def judge(self, control: bool = False) -> list[Check]:
        """The program's head outputs, stride-16 stage and detections
        (``control``: the reference's with float8 convs and products) against
        the reference's in float32, over the frames bfloat16 resolves
        (`_resolved`)."""
        lim, cfg = self.cell.limits, self.cfg
        t0 = time.perf_counter()
        model = yolo12.Model(cfg, self.state)
        low = yolo12.Model(cfg, self.state, fp8=True) if control else None
        gap, stage_gap, bad, of, boxes, n, kept = 0.0, 0.0, 0, 0, [], 0, 0
        _, strides = yolo.anchors(cfg["img_size"], self.frames.device)
        with torch.no_grad():
            for key, snap in sorted(self.snaps.items()):
                images = self.frames[snap["frames"]].permute(0, 3, 1, 2)
                levels, stage = self._levels(model, images)
                keep = self._resolved(model, images, levels, key)
                n, kept = n + int(keep.numel()), kept + int(keep.sum())
                if not keep.any():
                    continue
                idx = keep.nonzero().flatten().tolist()
                if control:
                    got, got_stage = self._levels(low, images)
                    dets = yolo.detections(*yolo.decode(got, cfg["img_size"], cfg["reg_max"]), cfg)
                else:
                    got = [(b.permute(0, 3, 1, 2), c.permute(0, 3, 1, 2)) for b, c in snap["head"]]
                    got_stage = snap["b4"].permute(0, 3, 1, 2)
                    dets = as_lists(snap["answers"])
                levels, got = ([tuple(t[idx] for t in pair) for pair in lv] for lv in (levels, got))
                dets = [dets[i] for i in idx]
                boxes_ref, conf, label = yolo.decode(levels, cfg["img_size"], cfg["reg_max"])
                ref_dets = yolo.detections(boxes_ref, conf, label, cfg)
                gap = max(gap, J.head_gap(got, levels))
                stage_gap = max(stage_gap, feature_gap(got_stage[idx], stage[idx]))
                b, f = J.detection_mismatch(dets, conf, ref_dets, cfg["conf_threshold"])
                bad, of = bad + b, of + f
                boxes += J.box_gaps(dets, boxes_ref, conf, strides, cfg["conf_threshold"])
        print(f"reference check: {len(self.snaps)} batches, {kept} of {n} frames resolved, {of} detections, "
              f"{len(boxes)} boxes at clear anchors (median gap {sorted(boxes)[len(boxes) // 2] if boxes else 0.0:.4f} "
              f"strides), {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        values = {"head_gap": gap if kept else float("inf"), "b4_gap": stage_gap if kept else float("inf"),
                  "detection_mismatch": J.share(bad, of),
                  "box_mismatch": J.share(sum(g > BOX_TOL for g in boxes), len(boxes)),
                  "unresolved_share": J.share(n - kept, n)}
        return [Check(k, float(v), float(lim.get(k, 0.0))) for k, v in values.items()]


def setup(cell, seed: int, device) -> Yolo12Session:
    return Yolo12Session(cell, seed, device)
