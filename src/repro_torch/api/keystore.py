"""On-disk keystore — owner-side key custody (DESIGN.md §9), a copy of
`repro.api.keystore`: a keystore directory written by either package is
read by the other.

A keystore is a directory of `<name>.ppkeys` files, each one `Keys`
wire payload (`core.ppanns.Keys.to_bytes`).  It lives with the *data
owner* (or a trusted user): the search service persists collections as
ciphertexts only and never touches a keystore — that separation is the
whole point of the role split.

`load` re-validates dimension on the way in (`expect_d`), so pointing a
d=512 collection at d=128 keys fails loudly instead of producing
garbage ciphertexts.
"""

from __future__ import annotations

import os
import pathlib

from ..core.ppanns import Keys

__all__ = ["Keystore"]

_SUFFIX = ".ppkeys"


class Keystore:
    def __init__(self, root: str | os.PathLike):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> pathlib.Path:
        if not name or "/" in name or name != os.path.basename(name):
            raise ValueError(f"bad key name {name!r}")
        return self.root / f"{name}{_SUFFIX}"

    def save(self, name: str, keys: Keys) -> pathlib.Path:
        """Atomic write: a crashed save never leaves a torn key file."""
        path = self.path(name)
        tmp = path.with_suffix(_SUFFIX + ".tmp")
        tmp.write_bytes(keys.to_bytes())
        os.replace(tmp, path)
        return path

    def load(self, name: str, *, expect_d: int | None = None) -> Keys:
        path = self.path(name)
        if not path.exists():
            raise KeyError(f"no keys named {name!r} in {self.root}")
        return Keys.from_bytes(path.read_bytes(), expect_d=expect_d)

    def names(self) -> list[str]:
        return sorted(p.name[: -len(_SUFFIX)]
                      for p in self.root.glob(f"*{_SUFFIX}"))

    def delete(self, name: str):
        path = self.path(name)
        if not path.exists():
            raise KeyError(f"no keys named {name!r} in {self.root}")
        path.unlink()
