"""Engine: load an engine directory and execute it (TRTModule's API).

    engine = Engine(path, device="cuda")
    engine.set_desired(["num_dets", "bboxes", "scores", "labels"])
    outputs = engine(tensor)            # e.g. a (1, 3, 640, 640) blob

The same API and output contracts as the JAX package's
`runtime/engine.py::Engine`, on the same directories (written by either
package's `save_engine`):

    <path>/meta.json         kind, model spec, NMS protocol
    <path>/params.msgpack    the parameter tree
    <path>/aot/*.pt2         optional `torch.export` programs of the
                             engine's graph, one per (input shape, input
                             dtype, activation dtype, platform):
                             `attach_aot` (no Python forward at call time)
    <path>/aot/*.aoti.pt2    optional AOTInductor packages of the same
                             graph, compiled for this card or CPU, with a
                             `.host.json` fingerprint beside each:
                             `attach_compiled` (no trace and no compile at
                             load; preferred over a .pt2 of the same key)

Engine kinds:

  "detect"    YOLOv8 (fused-BN layout) + DFL + stage-1 NMS; input a
              letterboxed blob, NCHW float [0, 1] RGB or NHWC; outputs
              num_dets / bboxes / scores / labels in letterboxed pixels.
  "classify"  the ViT classifier as stored (its attn_impl and quant run as
              they are); input NCHW or NHWC images in [-1, 1]; output
              "output", the logits.
  "two_stage" the whole pipeline on uint8 RGB frames (NHWC, or NCHW);
              outputs the TwoStagePipeline dict (TWO_STAGE_OUTPUTS).
              Built from a detect and a classify engine by
              `merge_two_stage_engine`.

An input whose second axis is 1 or 3 and whose last is not is taken as
NCHW and moved to NHWC.  Parameters stay in their stored dtypes; `dtype`
is the activation dtype (two_stage engines ingest uint8 frames).

The blobs take the parameters as an argument, as the JAX package's do:
the graph's inputs are the dict of the engine graph's parameters and
buffers (those `load_tree` made from params.msgpack included) and the
input tensor, so params.msgpack is stored once, whatever the number of
blobs.  A blob's name says what it runs (`_aot_name`); one directory may
hold the JAX package's blobs too (`.jaxexp`, `.jaxcomp`), which this
Engine ignores as the JAX Engine ignores these.  `Engine(...)(x)` runs the
compiled blob listed for x's shape, else the exported program, else the
model's Python forward (`last_path`: "compiled", "aot" or "eager").  The
hand-written kernels are operators of the graph (ops/library.py), so
every path launches the same kernels and counts them.
"""
from __future__ import annotations

import json
import os
import warnings
from types import SimpleNamespace

import torch
from torch import nn

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.config import detect_config_from_meta
from yolov8_vit_tpu_torch.models.vit import ViTClassifier, ViTSpec
from yolov8_vit_tpu_torch.models.yolov8 import YOLOv8, detect_spec
from yolov8_vit_tpu_torch.runtime.detector import decode_predictions
from yolov8_vit_tpu_torch.weights import load_pipeline_tree, load_tree, \
    read_engine, save_engine

DETECT_OUTPUTS = ("num_dets", "bboxes", "scores", "labels")
TWO_STAGE_OUTPUTS = ("num_dets", "boxes", "det_scores", "det_labels",
                     "final_valid", "cls_labels", "cls_scores")
CLASSIFY_OUTPUTS = ("output",)

AOT_EXT = ".pt2"              # torch.export program (attach_aot)
COMPILED_EXT = ".aoti.pt2"    # AOTInductor package (attach_compiled)
# inductor settings of every compiled blob: a cast that the graph rounds
# at (bf16 activations) rounds in the generated code too, as eagerly
EMULATE_PRECISION_CASTS = True


def _dtype_name(dtype) -> str:
    """torch.bfloat16 -> 'bfloat16' (numpy's and jnp's names)."""
    return str(dtype).rsplit(".", 1)[-1]


def _aot_name(shape: tuple, in_dtype, act_dtype, platform: str,
              ext: str = AOT_EXT) -> str:
    """'8x640x640x3_uint8-bfloat16_cuda.pt2': the blob of NHWC input
    `shape` of `in_dtype`, traced at activation dtype `act_dtype` for
    `platform` ("cuda" or "cpu")."""
    return "x".join(map(str, shape)) \
        + f"_{_dtype_name(in_dtype)}-{_dtype_name(act_dtype)}" \
        f"_{platform}{ext}"


def _parse_aot_name(name: str, ext: str = AOT_EXT):
    """'8x640x640x3_uint8-bfloat16_cuda.pt2' -> ((8, 640, 640, 3), 'uint8',
    'bfloat16', 'cuda'): (shape, input dtype, activation dtype, platform),
    as the JAX package's `_parse_aot_name` reads its names; None for a name
    of another kind (a compiled blob's when ext is AOT_EXT, the JAX
    package's .jaxexp / .jaxcomp) or one that does not parse."""
    if not name.endswith(ext) or (ext == AOT_EXT
                                  and name.endswith(COMPILED_EXT)):
        return None
    parts = name[:-len(ext)].rsplit("_", 2)
    if len(parts) != 3:
        return None
    try:
        shape = tuple(int(v) for v in parts[0].split("x"))
    except ValueError:
        return None
    in_dtype, _, act_dtype = parts[1].partition("-")
    return shape, in_dtype, act_dtype or in_dtype, parts[2]


def _blob_platform(platform: str | None) -> str:
    """The platform blobs are exported on: `platform`, else the card
    where there is one.  "cuda" without a card raises (resolve_device):
    the port exports only for the device it runs on."""
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"platform {platform!r}: the port's blobs are "
                         f"exported for 'cuda' or 'cpu'")
    _build.resolve_device(platform)
    return platform


def attach_aot(path: str, input_shapes, dtype=torch.float32,
               platform: str | None = None) -> list[str]:
    """Export the engine's graph for each NHWC input shape into
    `<path>/aot/` as a `torch.export` program (`torch.export.save`), which
    `Engine` loads with `torch.export.load(...).module()` and runs without
    the model's Python forward.  The program runs on the device it was
    exported on: `platform` "cuda" (the default where there is a card) or
    "cpu"; "cuda" on a machine without a card raises.  Returns the written
    paths."""
    platform = _blob_platform(platform)
    eng = Engine(path, device=platform, dtype=dtype, _load_aot=False)
    adir = os.path.join(path, "aot")
    os.makedirs(adir, exist_ok=True)
    written = []
    for shp in input_shapes:
        out = os.path.join(adir, _aot_name(tuple(shp), eng._input_dtype,
                                           dtype, platform))
        exported = eng.export(tuple(shp))
        exported.example_inputs = None     # the weights: not for the file
        torch.export.save(exported, out)
        written.append(out)
    return written


def attach_compiled(path: str, input_shapes, dtype=torch.float32) -> list[str]:
    """Compile the engine's graph for each NHWC input shape with
    AOTInductor into `<path>/aot/*.aoti.pt2`
    (`torch._inductor.aoti_compile_and_package`), which `Engine` loads
    with `aoti_load_package`: no trace and no compile at load.  Built for
    this machine's card (else its CPU), so each blob gets a
    `<blob>.host.json` sidecar with the build host's fingerprint
    (utils/hostinfo.py), and `Engine` refuses a blob built for another
    card, toolchain or CPU.  The kernels stay operators of the graph (the
    package calls them through the dispatcher).  Engine dirs are trusted
    artifacts: a package is a shared library that loading runs.  Returns
    the written paths."""
    from yolov8_vit_tpu_torch.utils.hostinfo import host_fingerprint
    platform = _blob_platform(None)
    eng = Engine(path, device=platform, dtype=dtype, _load_aot=False)
    adir = os.path.join(path, "aot")
    os.makedirs(adir, exist_ok=True)
    fingerprint = host_fingerprint(platform)
    written = []
    for shp in input_shapes:
        out = os.path.join(adir, _aot_name(tuple(shp), eng._input_dtype,
                                           dtype, platform, COMPILED_EXT))
        compile_package(eng.export(tuple(shp)), out,
                        {"mt_kind": eng.kind, "mt_weights": "argument"})
        with open(out + ".host.json", "w") as f:
            json.dump(fingerprint, f)
        written.append(out)
    return written


def compile_package(exported, out: str, metadata: dict) -> str:
    """AOTInductor package of an exported program at `out`, with
    `metadata` (string values; `aoti_load_package(...).get_metadata()` and
    the native driver read them) and the precision-cast setting."""
    meta = {k: str(v) for k, v in metadata.items()}
    meta["mt_emulate_precision_casts"] = str(int(EMULATE_PRECISION_CASTS))
    # AOTInductor compiles its C++ with -fopenmp, whatever the device
    cxx = _build.openmp_cxx()
    if cxx is None:
        raise RuntimeError("no host C++ compiler here links an OpenMP "
                           "program, which AOTInductor's build needs")
    with torch.no_grad():
        return torch._inductor.aoti_compile_and_package(
            exported, package_path=out,
            inductor_configs={
                "cpp.cxx": (cxx,),
                "emulate_precision_casts": EMULATE_PRECISION_CASTS,
                "aot_inductor.metadata": meta})


def merge_two_stage_engine(out_path: str, detect_engine: str,
                           classify_engine: str,
                           classify_budget: int = 4,
                           param_dtype=None) -> str:
    """Combine a detect engine and a classify engine into one two_stage
    engine dir, which runs the whole pipeline on uint8 frames: the JAX
    package's `merge_two_stage_engine`, with the same meta and tree
    ({"det": detect tree, "vit": classify tree})."""
    meta_d, params_d = read_engine(detect_engine)
    meta_c, params_c = read_engine(classify_engine)
    if meta_d.get("kind") != "detect" or meta_c.get("kind") != "classify":
        raise ValueError("merge needs a detect engine and a classify engine")
    meta = {"detect_cfg": meta_d.get("detect_cfg", {}),
            "vit_spec": meta_c.get("vit_spec", {}),
            "num_classes": meta_c.get("num_classes", 5),
            "classify_budget": classify_budget}
    if "det_spec" in meta_d:      # custom depth / width scales
        meta["det_spec"] = meta_d["det_spec"]
    return save_engine(out_path, "two_stage",
                       {"det": params_d, "vit": params_c}, meta,
                       param_dtype=param_dtype)


def _maybe_nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 4 and x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
        return x.permute(0, 2, 3, 1)
    return x


class EngineGraph(nn.Module):
    """What an engine computes, from the NHWC input tensor (the engine's
    input dtype, on its device) to its outputs dict: the graph that the
    blobs hold."""

    def __init__(self, kind: str, model: nn.Module, det_cfg=None):
        super().__init__()
        self.kind = kind
        self.model = model
        self.det_cfg = det_cfg

    def forward(self, x: torch.Tensor) -> dict:
        if self.kind == "detect":
            num, boxes, scores, labels = decode_predictions(self.model(x),
                                                            self.det_cfg)
            return {"num_dets": num, "bboxes": boxes, "scores": scores,
                    "labels": labels}
        if self.kind == "two_stage":
            return self.model(x.contiguous())
        return {"output": self.model(x)}


class _WeightsArgument(nn.Module):
    """`graph` with its parameters and buffers as an argument: forward(
    weights, x), weights the {name: tensor} dict of graph's tensors, so an
    exported program holds no weights."""

    def __init__(self, graph: nn.Module):
        super().__init__()
        object.__setattr__(self, "graph", graph)   # not a submodule

    def forward(self, weights: dict, x: torch.Tensor) -> dict:
        return torch.func.functional_call(self.graph, weights, (x,))


class Engine:
    """Load an engine directory and execute it (TRTModule parity)."""

    def __init__(self, path: str, device="cuda", dtype=torch.float32,
                 _load_aot: bool = True):
        self.path = path
        self.device = _build.resolve_device(device)
        self.dtype = dtype
        self.meta, tree = read_engine(path)
        self.kind = self.meta["kind"]
        meta = self.meta
        det_cfg = None
        if self.kind in ("detect", "two_stage"):
            self.det_cfg = det_cfg = detect_config_from_meta(
                meta.get("detect_cfg", {}))
            h, w = self.det_cfg.input_size
        if self.kind in ("classify", "two_stage"):
            self.vit_spec = ViTSpec(**meta.get("vit_spec", {}))
            self.num_classes = meta.get("num_classes", 5)
        # models are moved to the device before loading, so that the
        # derived buffers `load_tree` makes are made there
        if self.kind == "detect":
            self.model = YOLOv8(detect_spec(self.det_cfg,
                                            meta.get("det_spec")),
                                dtype=dtype).to(self.device)
            load_tree(self.model, tree["params"])
            self._desired = list(DETECT_OUTPUTS)
        elif self.kind == "classify":
            self.model = ViTClassifier(self.vit_spec, self.num_classes,
                                       dtype=dtype).to(self.device)
            load_tree(self.model, tree["params"])
            h = w = self.vit_spec.img_size
            self._desired = list(CLASSIFY_OUTPUTS)
        elif self.kind == "two_stage":
            # two_stage imports runtime.detector, whose package imports
            # this module
            from yolov8_vit_tpu_torch.models.two_stage import \
                TwoStagePipeline
            self.model = TwoStagePipeline(
                det_cfg=self.det_cfg, vit_spec=self.vit_spec,
                num_classes=self.num_classes,
                classify_budget=meta.get("classify_budget", 4),
                det_overrides=tuple(sorted(meta.get("det_spec", {}).items())),
                dtype=dtype, device=self.device)
            load_pipeline_tree(self.model, tree)
            self._desired = list(TWO_STAGE_OUTPUTS)
        else:
            raise ValueError(f"unknown engine kind {self.kind!r}")
        self.graph = EngineGraph(self.kind, self.model, det_cfg)
        self.inp_info = [SimpleNamespace(shape=(1, 3, h, w))]
        self._input_dtype = torch.uint8 if self.kind == "two_stage" \
            else dtype
        self._weights = None
        # blob registries, keyed by NHWC input shape: exported programs
        # (.pt2) and compiled packages (.aoti.pt2, preferred); a blob must
        # match the input dtype AND the activation dtype it was traced at
        self._aot: dict[tuple, str] = {}
        self._aot_fns: dict = {}
        self._compiled: dict[tuple, str] = {}
        self._compiled_fns: dict = {}
        self._compiled_failures: dict[tuple, int] = {}
        self.last_path = None     # "compiled" | "aot" | "eager" after a call
        if _load_aot:
            self._scan_blobs()

    def _scan_blobs(self) -> None:
        adir = os.path.join(self.path, "aot")
        if not os.path.isdir(adir):
            return
        platform = self.device.type
        in_name = _dtype_name(self._input_dtype)
        act_name = _dtype_name(self.dtype)
        mismatched, foreign = [], []
        for name in sorted(os.listdir(adir)):
            ext = COMPILED_EXT if name.endswith(COMPILED_EXT) else AOT_EXT
            parsed = _parse_aot_name(name, ext)
            if not parsed or parsed[3] != platform:
                continue
            if parsed[1] != in_name or parsed[2] != act_name:
                mismatched.append(name)
                continue
            blob = os.path.join(adir, name)
            if ext == COMPILED_EXT and not self._blob_host_ok(blob):
                foreign.append(name)       # refused here, never executed
                continue
            (self._compiled if ext == COMPILED_EXT else self._aot)[
                parsed[0]] = blob
        if foreign:
            warnings.warn(
                f"engine {self.path!r}: {len(foreign)} compiled blob(s) "
                f"were built on a host whose card, toolchain or CPU "
                f"features differ from this host's (e.g. {foreign[0]!r}); "
                f"executing them risks a failed load or a SIGILL, so they "
                f"are demoted to the portable .pt2 / eager path.  Re-run "
                f"attach_compiled on this machine.", stacklevel=3)
        if mismatched and not self._aot and not self._compiled:
            warnings.warn(
                f"engine {self.path!r}: {len(mismatched)} AOT blob(s) exist "
                f"for this platform but none match dtype {act_name} "
                f"(e.g. {mismatched[0]!r}); all shapes will run eagerly.  "
                f"Re-attach with attach_aot(..., dtype=torch.{act_name}) or "
                f"the export CLI's --aot-dtype.", stacklevel=3)

    def _blob_host_ok(self, blob: str) -> bool:
        """True when `blob`'s build-host sidecar (attach_compiled) is
        compatible with this host (utils/hostinfo.py); a blob without a
        readable sidecar is refused as well: it could come from anywhere."""
        from yolov8_vit_tpu_torch.utils.hostinfo import (compatible,
                                                         host_fingerprint)
        try:
            with open(blob + ".host.json") as f:
                blob_fp = json.load(f)
        except (OSError, ValueError):
            return False
        return compatible(blob_fp, host_fingerprint(self.device.type,
                                                    self.device))

    def weights(self) -> dict:
        """The {name: tensor} dict of the engine graph's parameters and
        buffers: the first argument of every blob."""
        if self._weights is None:
            self._weights = {**dict(self.graph.named_parameters()),
                             **dict(self.graph.named_buffers())}
        return self._weights

    def export(self, shape: tuple):
        """The engine's graph exported (`torch.export.export`) for an NHWC
        input of `shape` in its input dtype on its device, its weights an
        argument: forward(weights, x) -> outputs dict."""
        x = torch.zeros(shape, dtype=self._input_dtype, device=self.device)
        with torch.no_grad():
            return torch.export.export(_WeightsArgument(self.graph),
                                       (self.weights(), x))

    def set_desired(self, names) -> None:
        """Select and order the outputs __call__ returns."""
        self._desired = list(names)

    @torch.no_grad()
    def __call__(self, tensor):
        x = _maybe_nchw_to_nhwc(torch.as_tensor(tensor))
        x = x.to(self.device, self._input_dtype)
        key = tuple(x.shape)
        outs = None
        if key in self._compiled:
            outs = self._call_compiled(key, x)
        if outs is not None:
            self.last_path = "compiled"
        elif key in self._aot:
            fn = self._aot_fns.get(key)
            if fn is None:
                fn = torch.export.load(self._aot[key]).module()
                self._aot_fns[key] = fn
            outs = fn(self.weights(), x.contiguous())
            self.last_path = "aot"
        else:
            outs = self.graph(x)
            self.last_path = "eager"
        picked = tuple(outs[n] for n in self._desired)
        return picked if len(picked) > 1 else picked[0]

    def _call_compiled(self, key, x):
        """Run the compiled package for `key`, or return None after a
        failure: the first failure of a key warns and runs this call on the
        portable path, a second one in a row drops the key for good (JAX's
        rule).  The first call of a key synchronizes the card, so that a
        fault of the loaded code surfaces here and not in a later call."""
        try:
            fn = self._compiled_fns.get(key)
            first = fn is None
            if first:
                fn = torch._inductor.aoti_load_package(self._compiled[key])
            outs = fn(self.weights(), x.contiguous())
            if first:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._compiled_fns[key] = fn
                self._compiled_failures.pop(key, None)
            return outs
        except Exception as e:       # demote: the .pt2 / eager path runs
            self._compiled_fns.pop(key, None)
            fails = self._compiled_failures.get(key, 0) + 1
            self._compiled_failures[key] = fails
            if fails >= 2:
                del self._compiled[key]
                warnings.warn(
                    f"engine: compiled blob for shape {key} rejected by "
                    f"this platform ({type(e).__name__}: {e}); falling "
                    f"back to the portable path.  Re-run attach_compiled "
                    f"on this device.", stacklevel=3)
            else:
                warnings.warn(
                    f"engine: compiled blob for shape {key} failed once "
                    f"({type(e).__name__}: {e}); using the portable path "
                    f"for this call and retrying the blob next call (a bad "
                    f"blob demotes for good on the retry).", stacklevel=3)
            return None
