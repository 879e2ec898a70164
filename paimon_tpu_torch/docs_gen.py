"""The table options' documentation, generated from the port's
CoreOptions (port of paimon_tpu/docs_gen.py): one Markdown table of every
option's key, default and description, sorted by key.

Usage: python -m paimon_tpu_torch.docs_gen > options.md
"""

from __future__ import annotations

import enum

from .options import ConfigOption, CoreOptions, MemorySize

__all__ = ["generate_options_doc"]


def _fmt_default(v) -> str:
    if v is None:
        return "(none)"
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, bool):
        return str(v).lower()
    if isinstance(v, MemorySize):  # the JAX package's MemorySize prints its unit
        return f"{int(v)} b"
    return str(v)


def generate_options_doc() -> str:
    rows = []
    for name in dir(CoreOptions):
        opt = getattr(CoreOptions, name)
        if isinstance(opt, ConfigOption):
            rows.append((opt.key, _fmt_default(opt.default), opt.description))
    rows.sort()
    out = [
        "# Table options",
        "",
        "Auto-generated from `paimon_tpu_torch.options.CoreOptions`",
        "(the analog of the reference's ConfigOptionsDocGenerator).",
        "",
        "| Key | Default | Description |",
        "|---|---|---|",
    ]
    for key, default, desc in rows:
        out.append(f"| `{key}` | {default} | {desc} |")
    out.append("")
    out.append(
        "Per-field options use the `fields.<name>.<suffix>` pattern: "
        "`aggregate-function`, `sequence-group`, `ignore-retract`, "
        "`list-agg-delimiter`, `distinct`."
    )
    return "\n".join(out) + "\n"


if __name__ == "__main__":
    print(generate_options_doc(), end="")
