"""Leakage measurement harness (DESIGN.md §14): replay the server's view
against every security profile and score what an honest-but-curious
server actually extracts from it.  The counterpart of
`repro.sec.leakage`: the same views and attacks, with the server's
collection on the card (`device=None`) or on the host (`device="cpu"`);
on equal views the attacks return equal results.

The harness is the empirical half of `sec`: `profiles.py` states
what each tier hides; this module *measures* it, by reconstructing
exactly the observables the serving runtime hands the server for a
profile/backend pair (`ServerView`) and running the strongest attacks
we know against them:

  * `aspe_kpa_attack`     — the paper's §III KPA against ASPE variants
                            (the strawman the scheme replaces).  Profile
                            -independent; included so the frontier shows
                            where "no DCE" lands: success ≈ 1, broken.
  * `dce_kpa_attack`      — the §III KPA machinery *revived against
                            DCE*: the refine protocol's defined output
                            is the comparison sign of Z = 2 r_o r_p r_q
                            (d_oq - d_pq), so the KPA attacker feeds
                            sign(Z) to the Theorem-1 linear solver
                            exactly as it broke ASPE on raw scores.  It
                            fails at every tier — one bit per comparison
                            cannot support the linear reconstruction —
                            which is the paper's Theorem 3/4 claim,
                            measured rather than asserted.  (Measured
                            caveat, DESIGN.md §14: the float Z
                            *magnitudes* are NOT covered by that claim —
                            the per-row multiplicative r_o averages out
                            over many leaked rows, so a magnitude-
                            reading server recovers approximate
                            distances at every scan tier.  That residual
                            is what the "oblivious-sketch" tier's
                            TEE/FHE refine cost model prices out.)
  * `access_pattern_attack` — query localization from WHICH filter rows
                            each query's scan touched: the attacker
                            averages the touched DCPE ciphertexts and
                            uses the result as a query estimate.  This
                            succeeds against pooled IVF scans ("perf" /
                            "balanced") and collapses to the zero-
                            leakage baseline under the scan-oblivious
                            tiers ("hardened" / "oblivious-sketch"),
                            where every query touches every row.  The
                            graph backend reports its beam traversal's
                            visited bitmap as the trace: data-dependent
                            at every tier (the bounded-hop oblivious
                            variant fixes counts, not addresses), so
                            its hardened row lands between pooled IVF
                            and the full-bucket scan (DESIGN.md §15).
  * `adc_code_attack`     — the same localization run on the *decoded
                            ADC codes* instead of the f32 ciphertexts:
                            the quantized codes are stored server-side
                            with a keyless codebook, so they are fair
                            game for the attacker.  Distinguishes the
                            quantized backends' leakage tiers.

Every attack reports `normalized_success` in [0, 1] against an explicit
random-guess baseline (`core.attacks`), so "broken" (≈ 1) and "at
chance" (≈ 0) mean the same thing across data scales and attacks —
that is what makes the BENCH_attacks.json frontier comparable across
profiles, backends, and attack families.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import attacks, dcpe, ppanns
from ..data import synth
from .profiles import SecurityProfile, get_profile

__all__ = [
    "AttackResult",
    "ServerView",
    "capture_server_view",
    "aspe_kpa_attack",
    "dce_kpa_attack",
    "adc_code_attack",
    "access_pattern_attack",
    "evaluate_profile",
]


@dataclasses.dataclass(frozen=True)
class AttackResult:
    """One attack against one server view, scored against chance."""

    attack: str           # attack family, e.g. "access-pattern"
    profile: str          # security profile the view was captured under
    backend: str          # filter backend ("ivf", "ivf+int8", ...)
    err: float            # raw recovery error (attack-specific metric)
    baseline: float       # the same metric for a zero-leakage guesser
    success: float        # normalized in [0,1]: 1 broken, 0 at chance

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServerView:
    """Exactly what the honest-but-curious server observes for one
    profile/backend run — plus the plaintexts, which only the *evaluator*
    reads (to score recovery error; the attacks' inputs are the
    ciphertext fields and `touched`).

    `touched[i, j]` is True iff query i's filter scan read corpus row j:
    the access pattern a server (or anyone watching its memory traffic)
    records for free.  Pooled IVF scans touch only the probed posting
    lists; the scan-oblivious variants touch every row by construction.
    `first_touched` refines it with scan *order*, which the trace also
    exposes: the rows of the first-probed (nearest-centroid) posting
    list.  An oblivious scan is one undifferentiated full-bucket pass,
    so there `first_touched == touched` — order carries nothing.
    """

    profile: str
    backend: str
    C_sap: np.ndarray                     # (n, d) DCPE filter ciphertexts
    C_dce: np.ndarray                     # (n, 4, cdim) DCE ciphertexts
    Q_sap: np.ndarray                     # (nq, d) query filter ciphertexts
    T_q: np.ndarray                       # (nq, cdim) trapdoors
    touched: np.ndarray                   # (nq, n) bool access pattern
    first_touched: np.ndarray             # (nq, n) bool first-scanned rows
    codes_decoded: np.ndarray | None      # (n, d) decoded ADC codes
    P: np.ndarray                         # evaluator-only ground truth
    Q: np.ndarray                         # evaluator-only ground truth


def capture_server_view(
    profile: SecurityProfile | str,
    backend: str = "ivf",
    quantization: str | None = None,
    *,
    n: int = 2048,
    d: int = 32,
    nq: int = 64,
    k: int = 10,
    seed: int = 0,
    device=None,
) -> ServerView:
    """Build a small encrypted collection under `profile`, serve `nq`
    queries through the real backend scan paths, and record the server's
    observables.  Clustered data (`data.synth`) keeps the access
    pattern informative — iid Gaussians would understate the leak.
    `device` is where the owner encrypts and the collection serves
    (None: the card)."""
    from ..serving.runtime.collections import Collection

    prof = get_profile(profile)
    ds = synth.make_dataset("sift1m", n=n, n_queries=nq, d=d,
                            k_gt=k, seed=seed)
    beta = dcpe.suggest_beta(ds.base, fraction=0.01)
    owner = ppanns.DataOwner(d=d, sap_beta=beta, sap_s=1024.0, seed=seed)
    user = ppanns.User(owner.share_keys(), seed=seed + 1)
    C_sap, C_dce = owner.encrypt_vectors(ds.base, device=device)
    pairs = [user.encrypt_query(q) for q in ds.queries]
    Q_sap = np.stack([c for c, _ in pairs])
    T_q = np.stack([t for _, t in pairs])

    kw = {"quantization": quantization} if quantization else {}
    col = Collection("leak", f"{prof.name}-{backend}", d, backend=backend,
                     seed=seed, keyless=True, device=device,
                     security_profile=prof.name, **kw)
    try:
        col.insert_encrypted(C_sap, C_dce)
        # run the real scan path once: attaches the IVF/ADC state the
        # access pattern derives from, and proves the profile serves
        col.search_batch(Q_sap, T_q, k)
        bk = col._backend
        touched = np.zeros((nq, n), bool)
        first_touched = np.zeros((nq, n), bool)
        trace = getattr(bk, "last_scan_trace", None)
        if trace is not None:
            # Graph backend: the traversal's visited bitmap (the graph
            # walk's visited words, downloaded from the card) IS the access
            # pattern — which rows each query's beam expansion gathered.
            # It stays data-dependent even under the oblivious profile
            # (fixed hop/fanout COUNTS, data-dependent gather ADDRESSES:
            # the bounded-hop tier, DESIGN.md §15), so the graph's
            # hardened row sits between pooled IVF and the oblivious
            # full-bucket scan rather than collapsing to baseline.  The
            # expansion is one undifferentiated frontier stream, so
            # order carries nothing beyond membership.
            touched = np.asarray(trace, bool)[:, :n]
            first_touched = touched.copy()
        elif prof.oblivious or bk.ivf is None:
            touched[:, :] = True          # full-bucket scan, every query
            first_touched[:, :] = True    # one pass: no order signal
        else:
            for i, q in enumerate(Q_sap):
                cells = bk.ivf.partition_of(q, bk.nprobe)
                for j, c in enumerate(cells):
                    rows = np.asarray(bk.ivf.lists[c], np.int64)
                    touched[i, rows] = True
                    if j == 0:
                        first_touched[i, rows] = True
        codes_decoded = None
        cb = getattr(bk, "adc_codebook", None)
        if cb is not None:
            enc = cb.encode(C_sap)
            codes = enc[0] if isinstance(enc, tuple) else enc
            codes_decoded = np.asarray(cb.decode(codes), np.float32)
    finally:
        col.close()

    name = backend if not quantization else f"{backend}+{quantization}"
    return ServerView(profile=prof.name, backend=name, C_sap=C_sap,
                      C_dce=C_dce, Q_sap=Q_sap, T_q=T_q, touched=touched,
                      first_touched=first_touched,
                      codes_decoded=codes_decoded, P=ds.base, Q=ds.queries)


# ---------------------------------------------------------------------------
# The attacks.
# ---------------------------------------------------------------------------

def aspe_kpa_attack(transform: str = "linear", *, d: int = 8, n: int = 64,
                    nq: int = 24, seed: int = 0) -> AttackResult:
    """The §III KPA against the ASPE strawman (profile-independent):
    recovery to numerical precision, success ≈ 1.  The frontier's
    'what the scheme replaced' row."""
    rep = attacks.attack_report(d=d, n=n, nq=nq, transform=transform,
                                seed=seed)
    return AttackResult(attack=f"aspe-kpa-{transform}", profile="(aspe)",
                        backend="(none)", err=rep["query_err"],
                        baseline=rep["query_baseline"],
                        success=rep["query_success"])


def dce_kpa_attack(view: ServerView, n_leak: int | None = None
                   ) -> AttackResult:
    """The §III Theorem-1 KPA revived against DCE's comparison output.

    The refine stage's defined output per candidate pair is the SIGN of
    Z(o, pivot; q) = 2 r_o r_piv r_q (d(o,q) - d(pivot,q)) — "is o
    closer than the pivot".  A KPA attacker who leaked `n_leak`
    plaintext rows replays Theorem 1 on that observable: feed sign(Z)
    as the leak matrix and solve for the queries, exactly the attack
    that broke ASPE's raw scores.  It fails at every tier — one bit per
    (row, query) pair cannot support the d+2-unknown linear
    reconstruction — so the query estimate lands at the zero-leakage
    baseline.  That is the paper's Theorem 3/4 claim as a measurement.

    (Caveat, deliberately not gated here: the float Z *magnitudes* do
    leak — the per-row multiplicative r_o averages out under least
    squares over many leaked rows, so a magnitude-reading server
    recovers approximate distance differences at every scan tier.  The
    sign-only restriction below is the scheme's claimed interface; the
    magnitude residual is the "oblivious-sketch" tier's motivation and
    is discussed in DESIGN.md §14.)"""
    from ..core import dce

    d = view.P.shape[1]
    if n_leak is None:
        n_leak = min(8 * (d + 2), view.P.shape[0] // 2)
    C = view.C_dce.astype(np.float64)
    piv = view.C_dce.shape[0] - 1             # pivot outside the leaked set
    # Z[i, q] for the leaked rows vs every trapdoor — what the server's
    # own refine computes (core.dce.distance_comp, batched over queries)
    T = view.T_q.astype(np.float64)
    Z = ((C[:n_leak, 0, :] * C[piv, 2, :][None]) @ T.T
         - (C[:n_leak, 1, :] * C[piv, 3, :][None]) @ T.T)   # (n_leak, nq)
    assert np.allclose(
        Z[:2], np.stack([dce.distance_comp(view.C_dce[i], view.C_dce[piv],
                                           view.T_q.astype(np.float64))
                         for i in range(2)]), rtol=1e-3, atol=1e-3)
    Q_hat, _ = attacks.recover_queries_linear(view.P[:n_leak], np.sign(Z),
                                              transform="linear")
    err = float(np.median(np.linalg.norm(Q_hat - view.Q, axis=1)))
    baseline = float(np.median(np.linalg.norm(
        view.P[:n_leak].mean(0, keepdims=True) - view.Q, axis=1)))
    return AttackResult(attack="dce-kpa-sign", profile=view.profile,
                        backend=view.backend, err=err, baseline=baseline,
                        success=attacks.normalized_success(err, baseline))


def _localize(view: ServerView, rows: np.ndarray) -> AttackResult:
    """Shared core of the access-pattern attacks: estimate each query's
    filter ciphertext as the mean of the rows its scan touched FIRST
    (the nearest-centroid posting list — scan order is part of the
    trace), and score against the uninformed guess (the global corpus
    centroid — exactly what the estimate degenerates to when every
    query's scan is one undifferentiated full-bucket pass)."""
    sel = view.first_touched
    nq = sel.shape[0]
    counts = sel.sum(1, keepdims=True).astype(np.float64)
    Q_hat = (sel.astype(np.float64) @ rows.astype(np.float64)
             ) / np.maximum(counts, 1)
    err = float(np.median(
        np.linalg.norm(Q_hat - view.Q_sap, axis=1)))
    centroid = rows.mean(0, keepdims=True).astype(np.float64)
    baseline = float(np.median(np.linalg.norm(
        np.broadcast_to(centroid, (nq, rows.shape[1])) - view.Q_sap,
        axis=1)))
    return AttackResult(attack="", profile=view.profile,
                        backend=view.backend, err=err, baseline=baseline,
                        success=attacks.normalized_success(err, baseline))


def access_pattern_attack(view: ServerView) -> AttackResult:
    """Query localization from the filter access pattern over the f32
    DCPE ciphertexts: which rows a pooled IVF scan touches pins the
    query to its probed cells; a scan-oblivious profile touches all
    rows, collapsing the estimate to the global centroid (= baseline)."""
    res = _localize(view, view.C_sap)
    return dataclasses.replace(res, attack="access-pattern")


def adc_code_attack(view: ServerView) -> AttackResult:
    """The access-pattern distinguisher run on the decoded ADC codes:
    the server holds the codebook (it is keyless by design, DESIGN.md
    §11), so decoded codes are part of its view.  Quantization does not
    hide the pooled access pattern — only the oblivious scan does."""
    if view.codes_decoded is None:
        raise ValueError(
            f"view for backend {view.backend!r} has no ADC codes: "
            "capture with quantization='int8' or 'pq'")
    res = _localize(view, view.codes_decoded)
    return dataclasses.replace(res, attack="adc-code-pattern")


def evaluate_profile(
    profile: SecurityProfile | str,
    backend: str = "ivf",
    quantization: str | None = None,
    *,
    n: int = 2048,
    d: int = 32,
    nq: int = 64,
    seed: int = 0,
    device=None,
) -> list[AttackResult]:
    """Capture one server view (on `device`, None: the card) and run
    every applicable attack against it — one frontier point's leakage
    column."""
    view = capture_server_view(profile, backend, quantization,
                               n=n, d=d, nq=nq, seed=seed, device=device)
    results = [dce_kpa_attack(view), access_pattern_attack(view)]
    if view.codes_decoded is not None:
        results.append(adc_code_attack(view))
    return results
