"""Name lists that metric readers match device operations against."""

from __future__ import annotations

import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> list[str]:
    """The entries of `metrics/<name>`, one per line; `#` starts a comment."""
    with open(os.path.join(HERE, "metrics", name)) as f:
        lines = (line.split("#")[0].strip() for line in f)
        return [line for line in lines if line]


def kernel_base(name: str) -> str:
    """A device kernel's function name without namespaces, template
    arguments or parameters: `void (anonymous namespace)::tiled_kernel<false>
    (unsigned char const*, ...)` -> `tiled_kernel`."""
    name = name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i >= 0),
              default=len(name))
    return name[:cut].split()[-1].split("::")[-1] if name[:cut].split() else ""


def matches(name: str, entries: list[str]) -> bool:
    """Whether a device operation is one of `entries`: an entry is a
    function name (`plane_kernel`) or a name with its template arguments
    (`tiled_kernel<false>`)."""
    base = kernel_base(name)
    flat = name.replace("(anonymous namespace)::", "")
    return any(base == e.split("<")[0] and ("<" not in e or e in flat)
               for e in entries)


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))
