"""Generate docs/DOCSTRINGS.md: the public-API docstring reference.

Parity with the reference's DOCSTRINGS.md artifact, generated from the
code so it can never drift: every symbol exported by ``tsu_tpu.__all__``
plus the extended engine surfaces, with signatures and first
docstring paragraphs.

Run: python scripts/gen_docstrings.py  (part of docs upkeep, not `make
round` — regenerate when the public surface changes).
"""

from __future__ import annotations

import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Force CPU: generating docs must not touch (or wait on) the accelerator.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

EXTRA_SURFACES = [
    ("tsu_tpu.models.lattice_sampler", ["sample_grid", "sample_grid_ensemble"]),
    ("tsu_tpu.samplers.annealing",
     ["anneal_lattice", "anneal_spin_glass", "simulated_annealing_dense"]),
    ("tsu_tpu.parallel",
     ["make_mesh", "sharded_checkerboard_sweeps", "sharded_lattice_sample"]),
    ("tsu_tpu.samplers.tempering",
     ["parallel_tempering_lattice", "parallel_tempering_bonds"]),
    ("tsu_tpu.parallel.tempering_sharded",
     ["parallel_tempering_replica_sharded"]),
    ("tsu_tpu.ops.select", ["choose_sweep"]),
    ("tsu_tpu.ops.checkerboard_triton", ["halfsweep", "sweeps"]),
    ("tsu_tpu.checkpoint", ["save_state", "restore_state"]),
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _first_para(doc: str | None) -> str:
    if not doc:
        return "(no docstring)"
    return inspect.cleandoc(doc).split("\n\n")[0]


def _entry(name: str, obj) -> str:
    kind = "class" if inspect.isclass(obj) else "function" if callable(obj) else "object"
    lines = [f"### `{name}{_sig(obj) if callable(obj) else ''}`", ""]
    lines.append(_first_para(getattr(obj, "__doc__", None)))
    if inspect.isclass(obj):
        methods = [
            (n, m) for n, m in inspect.getmembers(obj, inspect.isfunction)
            if not n.startswith("_") and m.__qualname__.startswith(obj.__name__)
        ]
        for n, m in methods:
            lines.append("")
            lines.append(f"- **`.{n}{_sig(m)}`** — {_first_para(m.__doc__).splitlines()[0]}")
    del kind
    return "\n".join(lines)


def main():
    import tsu_tpu

    out = [
        "# Public API docstrings",
        "",
        "Generated by `python scripts/gen_docstrings.py` — do not edit by",
        "hand. Reference-parity symbols first (`tsu_tpu.__all__`, mirroring",
        "the reference package root), then the extended engine surfaces.",
        "",
        "## Flat namespace (`import tsu_tpu as tsu`)",
        "",
    ]
    for name in tsu_tpu.__all__:
        obj = getattr(tsu_tpu, name)
        out.append(_entry(name, obj))
        out.append("")
    out.append("## Extended engine surfaces")
    out.append("")
    for mod_name, names in EXTRA_SURFACES:
        mod = __import__(mod_name, fromlist=names)
        out.append(f"### module `{mod_name}`")
        out.append("")
        for name in names:
            obj = getattr(mod, name)
            out.append(_entry(f"{mod_name.split('.')[-1]}.{name}", obj))
            out.append("")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "docs", "DOCSTRINGS.md")
    with open(path, "w") as f:
        f.write("\n".join(out))
    n_syms = len(tsu_tpu.__all__) + sum(len(n) for _, n in EXTRA_SURFACES)
    print(f"wrote {path} ({n_syms} symbols)")


if __name__ == "__main__":
    main()
