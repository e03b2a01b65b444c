"""repro_torch.sec — leakage-tiered security profiles + the leakage
measurement harness (DESIGN.md §14), the counterpart of `repro.sec`.

Two halves:

  `profiles`  the `SecurityProfile` tiers (`perf` / `balanced` /
              `hardened` / `oblivious-sketch`) that a runtime
              `Collection` threads into its scheduler (batch padding)
              and filter backend (scan-oblivious variants), and the api
              layer into its result widths.
  `leakage`   the measurement side: replay the server's view
              (ciphertexts, ADC codes, access traces — the graph walk's
              visited words come off the card) and run the §III KPA
              attacks plus the DCE/ADC/trace distinguishers against
              every profile, reporting normalized attack success (0 =
              random guessing, 1 = exact recovery).

Exports resolve lazily, as in the JAX package.
"""

import importlib

_EXPORTS = {
    # profiles
    "SecurityProfile": ".profiles",
    "PROFILES": ".profiles",
    "SECURITY_PROFILE_NAMES": ".profiles",
    "DEFAULT_PROFILE": ".profiles",
    "get_profile": ".profiles",
    # leakage harness
    "AttackResult": ".leakage",
    "ServerView": ".leakage",
    "capture_server_view": ".leakage",
    "aspe_kpa_attack": ".leakage",
    "dce_kpa_attack": ".leakage",
    "adc_code_attack": ".leakage",
    "access_pattern_attack": ".leakage",
    "evaluate_profile": ".leakage",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(_EXPORTS[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
