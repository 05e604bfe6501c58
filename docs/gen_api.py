"""Generate docs/API.md from package docstrings.

The reference ships sphinx autodoc (`/root/reference/docs/conf.py`);
this repo keeps the same contract — API docs generated from the
docstrings, never hand-maintained — without adding a sphinx build:

    python docs/gen_api.py          # rewrites docs/API.md

Runs on CPU (forces jax_platforms=cpu so importing models never
initializes a GPU).
"""

from __future__ import annotations

import importlib
import inspect
import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODULES = [
    "radiocore_tpu",
    "radiocore_tpu.models.fm",
    "radiocore_tpu.models.mfm",
    "radiocore_tpu.models.wbfm",
    "radiocore_tpu.models.pll",
    "radiocore_tpu.models.bandpass",
    "radiocore_tpu.models.decimate",
    "radiocore_tpu.models.deemphasis",
    "radiocore_tpu.tools.tuner",
    "radiocore_tpu.tools.buffer",
    "radiocore_tpu.tools.ringbuffer",
    "radiocore_tpu.tools.carrousel",
    "radiocore_tpu.tools.chopper",
    "radiocore_tpu.ops.fft",
    "radiocore_tpu.ops.fir",
    "radiocore_tpu.ops.resample",
    "radiocore_tpu.ops.channelize",
    "radiocore_tpu.ops.pfb",
    "radiocore_tpu.ops.analytic",
    "radiocore_tpu.ops.nco_pll",
    "radiocore_tpu.ops.deemphasis",
    "radiocore_tpu.ops.demod",
    "radiocore_tpu.ops.design",
    "radiocore_tpu.ops.synth",
    "radiocore_tpu.parallel.mesh",
    "radiocore_tpu.parallel.halo",
    "radiocore_tpu.parallel.fft_sharded",
    "radiocore_tpu.parallel.channelize_sharded",
    "radiocore_tpu.parallel.comm_analysis",
    "radiocore_tpu.parallel.pipeline",
    "radiocore_tpu.runtime.config",
    "radiocore_tpu.runtime.platform",
    "radiocore_tpu.runtime.transfer",
    "radiocore_tpu.runtime.ingest",
    "radiocore_tpu.runtime.compile_cache",
    "radiocore_tpu.runtime.checkpoint",
    "radiocore_tpu.runtime.metrics",
    "radiocore_tpu.runtime.profiling",
    "radiocore_tpu.apps.iq",
    "radiocore_tpu.apps.receive_fm",
    "radiocore_tpu.apps.multi_fm_server",
    "radiocore_tpu.apps.multi_fm_receiver",
]


def first_para(doc: str | None) -> str:
    if not doc:
        return "*(no docstring)*"
    return inspect.cleandoc(doc).split("\n\n")[0].replace("\n", " ")


def full_doc(doc: str | None, indent: str = "") -> str:
    if not doc:
        return ""
    return "\n".join(indent + line
                     for line in inspect.cleandoc(doc).splitlines())


def sig_of(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def document_module(name: str, out: io.StringIO) -> None:
    mod = importlib.import_module(name)
    out.write(f"\n## `{name}`\n\n")
    out.write(first_para(mod.__doc__) + "\n")

    members = []
    for attr, obj in vars(mod).items():
        if attr.startswith("_"):
            continue
        if getattr(obj, "__module__", None) != name:
            continue  # re-exports are documented at their home module
        if inspect.isfunction(obj) or inspect.isclass(obj):
            members.append((attr, obj))
    members.sort(key=lambda kv: inspect.getsourcelines(kv[1])[1])

    for attr, obj in members:
        if inspect.isclass(obj):
            out.write(f"\n### class `{attr}{sig_of(obj)}`\n\n")
            out.write(first_para(obj.__doc__) + "\n")
            for m_name, m in inspect.getmembers(obj, inspect.isfunction):
                if m_name.startswith("_") or m.__qualname__.split(".")[0] != attr:
                    continue
                out.write(f"\n- **`{m_name}{sig_of(m)}`** — "
                          f"{first_para(m.__doc__)}\n")
            for p_name, p in inspect.getmembers(
                    obj, lambda o: isinstance(o, property)):
                out.write(f"\n- *property* **`{p_name}`** — "
                          f"{first_para(p.fget.__doc__ if p.fget else None)}\n")
        else:
            out.write(f"\n### `{attr}{sig_of(obj)}`\n\n")
            out.write(first_para(obj.__doc__) + "\n")


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")

    out = io.StringIO()
    out.write(
        "# radiocore_tpu API reference\n\n"
        "Generated from docstrings by `docs/gen_api.py` — do not edit "
        "by hand; regenerate with `python docs/gen_api.py`.\n\n"
        "Conventions shared by every op/model: all compute functions "
        "are pure and jit-compatible, operate along the LAST axis with "
        "arbitrary leading batch dims, take streaming state explicitly "
        "as a pytree, and design all filters/windows in host NumPy at "
        "construction time (see docs/ARCHITECTURE.md).\n")
    for name in MODULES:
        document_module(name, out)

    path = os.path.join(os.path.dirname(__file__), "API.md")
    with open(path, "w") as f:
        f.write(out.getvalue())
    print(f"wrote {path} ({len(out.getvalue())} bytes, "
          f"{len(MODULES)} modules)")


if __name__ == "__main__":
    sys.exit(main())
