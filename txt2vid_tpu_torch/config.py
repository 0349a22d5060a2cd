"""Reflection-based component specs (counterpart of txt2vid_tpu/config.py).

A spec is a dotted path ("pkg.mod.Name"), a path to a JSON file, inline JSON,
or a dict {"class": "pkg.mod.Name", "args": {...}}; keyword arguments
override the spec's args. Specs written for the JAX package
(`txt2vid_tpu.*`) and for the reference (`txt2vid.*`, through the JAX
package's alias table) resolve to the port's counterparts
(`txt2vid_tpu_torch.*`), so the shipped launch scripts and config/*.json work
with only the module name changed.

Model args carry over: `use_pallas` becomes `use_kernel` (None -> True),
`init_method` is kept on the object for ops.initializers.init_from_seed,
`remat` passes through (models/tganv2.py), `stem_impl` is accepted and
dropped (the port has only the conv stem, which holds the same parameters),
and `dtype` ("bfloat16" or "float32", with or without a "jnp." or
"jax.numpy." prefix, a dtype object of that name, or a torch dtype) becomes
the module's torch dtype.
"""

import importlib
import json
from pathlib import Path

import torch

# reference dotted paths -> the JAX package's, as txt2vid_tpu/config.py maps them
LEGACY_ALIASES = {
    "txt2vid.models.tganv2_cond.gen.MultiScaleGen": "txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
    "txt2vid.models.tganv2_cond.discrim.MultiScaleDiscrim": "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim",
    "txt2vid.models.tganv2.gen.MultiScaleGen": "txt2vid_tpu.models.tganv2.MultiScaleGen",
    "txt2vid.models.tganv2.discrim.MultiScaleDiscrim": "txt2vid_tpu.models.tganv2.MultiScaleDiscrim",
    "txt2vid.models.tgan.gen.Gen": "txt2vid_tpu.models.tgan.Gen",
    "txt2vid.models.tgan.discrim.Discrim": "txt2vid_tpu.models.tgan.Discrim",
    "txt2vid.models.tcwyt.gen.Gen": "txt2vid_tpu.models.tcwyt.Gen",
    "txt2vid.models.tcwyt.video_discrim.VideoDiscrim": "txt2vid_tpu.models.tcwyt.VideoDiscrim",
    "txt2vid.models.tcwyt.frame_discrim.FrameDiscrim": "txt2vid_tpu.models.tcwyt.FrameDiscrim",
    "txt2vid.models.tcwyt.frame_discrim.FrameMap": "txt2vid_tpu.models.tcwyt.FrameMap",
    "txt2vid.models.tcwyt.motion_discrim.MotionDiscrim": "txt2vid_tpu.models.tcwyt.MotionDiscrim",
    "txt2vid.models.img.models.Gen": "txt2vid_tpu.models.img.Gen",
    "txt2vid.models.img.models.Discrim": "txt2vid_tpu.models.img.Discrim",
    "txt2vid.models.txt.basic.Seq2Seq": "txt2vid_tpu.models.txt.Seq2Seq",
    "txt2vid.gan.losses": "txt2vid_tpu.gan.losses",
    "txt2vid.data": "txt2vid_tpu.data",
}
_JAX_PACKAGE = "txt2vid_tpu"
_PORT = "txt2vid_tpu_torch"


def resolve_alias(dotted: str) -> str:
    """A reference or JAX-package path -> the port's path."""
    if dotted in LEGACY_ALIASES:
        dotted = LEGACY_ALIASES[dotted]
    else:
        for prefix, target in LEGACY_ALIASES.items():
            if dotted.startswith(prefix + "."):
                dotted = target + dotted[len(prefix):]
                break
    if dotted.startswith(_JAX_PACKAGE + "."):
        dotted = _PORT + dotted[len(_JAX_PACKAGE):]
    return dotted


def get_class(dotted: str):
    """Import `pkg.mod.Name` (after resolve_alias) and return the attribute;
    NotImplementedError for a component the port does not have yet."""
    resolved = resolve_alias(dotted)
    module, _, name = resolved.rpartition(".")
    try:
        return getattr(importlib.import_module(module), name)
    except (ImportError, AttributeError) as e:
        if resolved.startswith(_PORT + "."):
            raise NotImplementedError(f"{dotted} ({resolved}) is not in the port yet") from e
        raise


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(dtype):
    """A model's compute dtype in the port's terms: None, a torch dtype, or the
    name of bfloat16 / float32 as a JAX spec or jnp writes it."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(
        dtype, "name", getattr(dtype, "__name__", repr(dtype)))
    for prefix in ("jnp.", "jax.numpy."):
        name = name.removeprefix(prefix)
    if name not in _DTYPES:
        raise ValueError(f"model arg dtype={dtype!r}: the port computes in "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


def _carry_over_args(args: dict) -> tuple[dict, str | None]:
    """The JAX package's model args in the port's terms; returns (args, init_method)."""
    args = dict(args)
    if args.get("dtype") is None:
        args.pop("dtype", None)
    else:
        args["dtype"] = torch_dtype(args["dtype"])
    args.pop("stem_impl", None)
    if "use_pallas" in args:
        use = args.pop("use_pallas")
        args["use_kernel"] = True if use is None else bool(use)
    return args, args.pop("init_method", None)


def create_object(spec, **kwargs):
    """Instantiate a component from a spec; kwargs override the spec's args."""
    if isinstance(spec, str):
        spec = spec.strip()
        if spec.startswith("{"):
            return create_object(json.loads(spec), **kwargs)
        if Path(spec).exists():
            with open(spec) as f:
                return create_object(json.load(f), **kwargs)
        return create_object({"class": spec}, **kwargs)
    if not (isinstance(spec, dict) and "class" in spec):
        raise ValueError(f"bad component spec: {spec!r}")
    cls = get_class(spec["class"])
    args = dict(spec.get("args", {}))
    args.update(kwargs)
    args, init_method = _carry_over_args(args)
    obj = cls(**args)
    if init_method is not None:
        obj.init_method = init_method
    return obj
