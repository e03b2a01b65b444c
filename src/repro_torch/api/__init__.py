"""repro_torch.api — the public, role-typed client/service surface
(DESIGN.md §9, §10), the counterpart of `repro.api`.

The paper's threat model has three roles — data owner, user, untrusted
server — and this package is their protocol: typed dataclasses
(`IndexSpec`, `PlacementSpec`, `SearchParams`, `EncryptedQuery`,
`SearchRequest`, `SearchResult`, `EncryptedCorpus`) with versioned
`to_bytes`/`from_bytes` wire round-trips, role objects
(`DataOwnerClient`, `QueryClient`, `SecureAnnService`), an on-disk
`Keystore` (owner-side), and persistent encrypted collections
(`SecureAnnService.save`/`load` — ciphertexts only, never keys).  Frames,
keystores and `.ppcol` files are those of the JAX package, byte for
byte, so either package reads what the other wrote.

The service and the owner's batched encryption run on the card unless
the caller passes `device="cpu"`.

Not here yet: the JAX package's `api/mesh.py` names
(`DistributedSecureAnnService`, `build_secure_scan_step`,
`build_secure_scan_step_gspmd`, `secure_scan_input_specs`,
`secure_scan_pspecs`) and sharded placement come with placement and
sharding (ROADMAP Queue 1 item 6).

Exports resolve lazily so `import repro_torch.api` stays light.
"""

import importlib

_EXPORTS = {
    # protocol types + wire format
    "PROTOCOL_VERSION": ".protocol",
    "WireFormatError": ".protocol",
    "IndexSpec": ".protocol",
    "PlacementSpec": ".protocol",
    "SearchParams": ".protocol",
    "EncryptedQuery": ".protocol",
    "EncryptedCorpus": ".protocol",
    "SearchRequest": ".protocol",
    "SearchResult": ".protocol",
    "SearchStats": ".protocol",
    "Keys": ".protocol",
    "suggest_beta": ".protocol",
    # roles
    "DataOwnerClient": ".roles",
    "QueryClient": ".roles",
    "SecureAnnService": ".roles",
    "TenantIsolationError": ".roles",
    "QueueFullError": ".roles",
    # key custody
    "Keystore": ".keystore",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(_EXPORTS[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
