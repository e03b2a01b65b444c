"""HNSW proximity graph (Malkov & Yashunin, TPAMI'20) — the paper's filter
index (§V-A), built *over DCPE ciphertexts* so edges only reflect noised,
approximate neighborhoods.

Implementation notes
  * Host-side numpy, a verbatim copy of `repro.core.hnsw`: the same seed
    and the same C_SAP build a bit-identical graph (`to_arrays()`) in both
    packages.  Serving walks the graph on the card instead
    (`repro_torch.graph`: the CSR mirror, the batched traversal and the
    graph_expand CUDA kernel); this class stays the owner's builder and
    the per-query parity oracle.
  * The index never sees plaintexts in the PP-ANNS scheme: `build` is fed
    C_SAP; distance comparisons during build/search happen on ciphertexts.
  * Supports incremental insert and delete-with-repair (paper §V-D).
    `delete` finds a node's in-neighbours in a padded copy of the link
    rows, kept across a burst of deletes (an insert drops it), instead of
    the JAX package's Python scan over every row: the same rows are
    repaired in the same order, so the graph stays bit-identical.
"""

from __future__ import annotations

import heapq

import numpy as np

__all__ = ["HNSW"]


class HNSW:
    def __init__(
        self,
        dim: int,
        M: int = 16,
        ef_construction: int = 200,
        seed: int = 0,
    ):
        self.dim = dim
        self.M = M
        self.M0 = 2 * M
        self.mL = 1.0 / np.log(M)
        self.efC = ef_construction
        self._rng = np.random.default_rng(seed)
        self._X = np.zeros((0, dim), np.float32)
        self._n = 0
        self.levels: list[int] = []
        # links[lev] is a list over node ids; entry is an int32 ndarray of
        # neighbor ids or None if the node does not reach that level.
        self.links: list[list] = []
        self.entry = -1
        self.max_level = -1
        self.n_dist_evals = 0          # instrumentation for benchmarks
        # per level, the link rows padded with -1 to (n, cap): the
        # in-neighbour index of a delete burst (None: rebuilt on demand)
        self._padded = None

    # ------------------------------------------------------------- storage

    @property
    def size(self) -> int:
        return self._n

    @property
    def vectors(self) -> np.ndarray:
        return self._X[: self._n]

    def _ensure_capacity(self, extra: int):
        need = self._n + extra
        if need <= self._X.shape[0]:
            return
        cap = max(need, 2 * self._X.shape[0], 1024)
        grown = np.zeros((cap, self.dim), np.float32)
        grown[: self._n] = self._X[: self._n]
        self._X = grown

    def _dists(self, q: np.ndarray, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        self.n_dist_evals += ids.size
        diff = self._X[ids] - q
        return np.einsum("nd,nd->n", diff, diff)

    # ------------------------------------------------------------ building

    def build(self, X: np.ndarray, progress_every: int = 0):
        """Insert all rows of X (ciphertexts in the PP scheme)."""
        X = np.asarray(X, np.float32)
        self._ensure_capacity(len(X))
        for i, x in enumerate(X):
            self.insert(x)
            if progress_every and (i + 1) % progress_every == 0:
                print(f"hnsw: inserted {i + 1}/{len(X)}")
        return self

    def insert(self, x: np.ndarray) -> int:
        x = np.asarray(x, np.float32)
        self._padded = None              # link rows change: drop the index
        self._ensure_capacity(1)
        node = self._n
        self._X[node] = x
        self._n += 1
        lvl = int(-np.log(self._rng.uniform(1e-12, 1.0)) * self.mL)
        self.levels.append(lvl)

        old_max = self.max_level          # layers that already have nodes
        while self.max_level < lvl:
            self.max_level += 1
            self.links.append([None] * node)
        for lev in range(len(self.links)):
            self.links[lev].append(
                np.zeros(0, np.int32) if lev <= lvl else None)

        if self.entry < 0:
            self.entry = node
            return node

        ep = [self.entry]
        for lev in range(old_max, lvl, -1):
            ep = [self._greedy(x, ep[0], lev)]
        # only connect on layers that existed before this insert; on brand-new
        # upper layers the node starts link-less and becomes the entry point.
        for lev in range(min(lvl, old_max), -1, -1):
            W = self._search_layer(x, ep, self.efC, lev)
            m = self.M if lev > 0 else self.M0
            selected = self._select_heuristic(W, m)
            self.links[lev][node] = np.asarray(selected, np.int32)
            for nb in selected:
                self._add_link(nb, node, lev)
            ep = [i for _, i in W]
        if lvl > self.levels[self.entry]:
            self.entry = node
        return node

    def _add_link(self, src: int, dst: int, lev: int):
        cur = self.links[lev][src]
        cap = self.M if lev > 0 else self.M0
        merged = np.append(cur, np.int32(dst))
        if merged.size <= cap:
            self.links[lev][src] = merged
            return
        # overflow: re-select diverse neighbors around src
        d = self._dists(self._X[src], merged)
        order = np.argsort(d)
        W = [(float(d[i]), int(merged[i])) for i in order]
        self.links[lev][src] = np.asarray(
            self._select_heuristic(W, cap), np.int32)

    def _select_heuristic(self, W, m: int) -> list[int]:
        """Algorithm 4: keep a candidate only if it is closer to the new
        point than to every already-selected neighbor (diversity); fill
        remaining slots with the closest pruned candidates."""
        selected: list[int] = []
        pruned: list[int] = []
        for d, c in W:
            if len(selected) >= m:
                break
            if selected:
                dc = self._dists(self._X[c], selected)
                if (dc < d).any():
                    pruned.append(c)
                    continue
            selected.append(c)
        for c in pruned:
            if len(selected) >= m:
                break
            selected.append(c)
        return selected

    # ----------------------------------------------------------- searching

    def _greedy(self, q: np.ndarray, ep: int, lev: int) -> int:
        cur = ep
        cur_d = float(self._dists(q, [cur])[0])
        while True:
            neigh = self.links[lev][cur]
            if neigh is None or neigh.size == 0:
                return cur
            d = self._dists(q, neigh)
            j = int(np.argmin(d))
            if d[j] >= cur_d:
                return cur
            cur, cur_d = int(neigh[j]), float(d[j])

    def _search_layer(self, q: np.ndarray, eps, ef: int, lev: int):
        """Standard ef-search; returns [(dist, id)] ascending."""
        eps = list(dict.fromkeys(int(e) for e in eps))
        d0 = self._dists(q, eps)
        visited = set(eps)
        cand = [(float(d), e) for d, e in zip(d0, eps)]
        heapq.heapify(cand)
        result = [(-float(d), e) for d, e in zip(d0, eps)]
        heapq.heapify(result)
        while len(result) > ef:
            heapq.heappop(result)
        while cand:
            d, c = heapq.heappop(cand)
            if d > -result[0][0] and len(result) >= ef:
                break
            neigh = self.links[lev][c]
            if neigh is None or neigh.size == 0:
                continue
            new = [int(n) for n in neigh if int(n) not in visited]
            if not new:
                continue
            visited.update(new)
            nd = self._dists(q, new)
            bound = -result[0][0]
            for dist, nid in zip(nd, new):
                dist = float(dist)
                if len(result) < ef or dist < bound:
                    heapq.heappush(cand, (dist, nid))
                    heapq.heappush(result, (-dist, nid))
                    if len(result) > ef:
                        heapq.heappop(result)
                    bound = -result[0][0]
        out = [(-nd, i) for nd, i in result]
        out.sort()
        return out

    def search(self, q: np.ndarray, k: int, ef: int = 64):
        """k-ANN of q; returns (ids (k,), dists (k,)) ascending."""
        if self._n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        q = np.asarray(q, np.float32)
        ep = self.entry
        for lev in range(self.max_level, 0, -1):
            ep = self._greedy(q, ep, lev)
        W = self._search_layer(q, [ep], max(ef, k), 0)
        W = W[:k]
        ids = np.asarray([i for _, i in W], np.int64)
        ds = np.asarray([d for d, _ in W], np.float32)
        return ids, ds

    # ------------------------------------------------- maintenance (§V-D)

    def delete(self, node: int) -> list[int]:
        """Delete a vector; in-neighbors are repaired by re-running neighbor
        selection over their remaining candidates (paper §V-D).  Returns the
        repaired in-neighbor ids — the only other nodes whose link rows
        changed — so a derived mirror (graph.csr.CSRGraph) can refresh
        exactly the touched rows instead of rebuilding."""
        repaired: set[int] = set()
        if self._padded is None:
            self._padded = [self._pad_rows(rows, self.M if lev else self.M0)
                            for lev, rows in enumerate(self.links)]
        for lev in range(len(self.links)):
            if self.links[lev][node] is None:
                continue
            padded = self._padded[lev]
            # every src whose row holds node, ascending, as the scan over
            # all rows finds them (a None row is all -1, and a repair
            # below never adds node to a row)
            for src in np.flatnonzero((padded == node).any(1)).tolist():
                if src == node:
                    continue
                nb = self.links[lev][src]
                repaired.add(src)
                keep = nb[nb != node]
                # repair: reconnect through the deleted node's neighbors
                cands = np.unique(np.concatenate(
                    [keep, self.links[lev][node][
                        self.links[lev][node] != src]]))
                cands = cands[cands != src]
                if cands.size:
                    d = self._dists(self._X[src], cands)
                    order = np.argsort(d)
                    W = [(float(d[i]), int(cands[i])) for i in order]
                    cap = self.M if lev > 0 else self.M0
                    self.links[lev][src] = np.asarray(
                        self._select_heuristic(W, cap), np.int32)
                else:
                    self.links[lev][src] = keep
                row = self.links[lev][src]
                padded[src] = -1
                padded[src, : row.size] = row
            self.links[lev][node] = None
            padded[node] = -1
        self.levels[node] = -1
        self._X[node] = np.inf       # unreachable by distance
        if self.entry == node:
            alive = [i for i, l in enumerate(self.levels) if l >= 0]
            self.entry = max(alive, key=lambda i: self.levels[i]) if alive else -1
            self.max_level = self.levels[self.entry] if alive else -1
        return sorted(repaired)

    @staticmethod
    def _pad_rows(rows: list, cap: int) -> np.ndarray:
        """A level's link rows as an (n, cap) int32 matrix, -1 padded
        (None rows all -1); cap is the level's degree bound."""
        cap = max([cap] + [r.size for r in rows if r is not None])
        out = np.full((len(rows), cap), -1, np.int32)
        for i, r in enumerate(rows):
            if r is not None and r.size:
                out[i, : r.size] = r
        return out

    # -------------------------------------------------------- persistence

    def to_arrays(self) -> dict:
        flat, offsets = [], []
        for lev in range(len(self.links)):
            for nb in self.links[lev]:
                offsets.append(len(flat) if nb is not None else -1)
                if nb is not None:
                    flat.extend([len(nb)] + nb.tolist())
        return {
            "X": self._X[: self._n],
            "levels": np.asarray(self.levels, np.int32),
            "flat": np.asarray(flat, np.int32),
            "offsets": np.asarray(offsets, np.int64),
            # n_layers can exceed max_level+1: deleting the top node
            # lowers max_level but the (empty) upper link layers remain
            "meta": np.asarray(
                [self.M, self.efC, self.entry, self.max_level, self._n,
                 len(self.links)]),
        }

    @classmethod
    def from_arrays(cls, arrs: dict) -> "HNSW":
        meta = [int(v) for v in arrs["meta"]]
        M, efC, entry, max_level, n = meta[:5]
        n_layers = meta[5] if len(meta) > 5 else max_level + 1
        self = cls(dim=arrs["X"].shape[1], M=M, ef_construction=efC)
        self._X = np.asarray(arrs["X"], np.float32).copy()
        self._n = n
        self.levels = arrs["levels"].tolist()
        self.entry, self.max_level = entry, max_level
        flat, offsets = arrs["flat"], arrs["offsets"]
        self.links = []
        pos = 0
        for lev in range(n_layers):
            layer = []
            for node in range(n):
                off = offsets[pos]
                pos += 1
                if off < 0:
                    layer.append(None)
                else:
                    cnt = int(flat[off])
                    layer.append(flat[off + 1: off + 1 + cnt].copy())
            self.links.append(layer)
        return self
