// fasp_native — native host-side graph/factorization kernels.
//
// The compute path of the framework is JAX/XLA/Pallas on TPU; these are the
// *setup-phase* irregular graph algorithms (the part the reference
// implements as serial C: BlaILU.c, BlaSparseCSR.c multicoloring,
// PreAMGAggregation*.inl, BlaILUSetupBSR.c topologic_sort_ILU).  They are
// sequential pointer-chasing workloads — the wrong shape for a TPU and for
// NumPy — so they live here as a small C++ library with a plain C ABI,
// loaded via ctypes (no pybind11 dependency).
//
// Conventions: CSR int32 indptr/indices, float64 data, 0-based, rows sorted.
// All functions return >= 0 on success; negative values are error/overflow
// codes documented per function.

#include <algorithm>
#include <cmath>
#ifdef _OPENMP
#include <omp.h>
#endif
#include <cstdint>
#include <cstring>
#include <queue>
#include <set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Greedy distance-1 multicoloring (reference: dCSRmat_Multicoloring,
// BlaSparseCSR.c:1687).  color[n] out; returns number of colors.
// ---------------------------------------------------------------------------
int fasp_greedy_color(int n, const int32_t* indptr, const int32_t* indices,
                      int32_t* color) {
    std::vector<int32_t> mark(n + 1, -1);
    int ncolor = 0;
    for (int i = 0; i < n; ++i) color[i] = -1;
    for (int i = 0; i < n; ++i) {
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int32_t j = indices[p];
            if (j != i && color[j] >= 0) mark[color[j]] = i;
        }
        int c = 0;
        while (c < n && mark[c] == i) ++c;
        color[i] = c;
        if (c + 1 > ncolor) ncolor = c + 1;
    }
    return ncolor;
}

// ---------------------------------------------------------------------------
// Triangular dependency levels (reference: topologic_sort_ILU,
// BlaILUSetupBSR.c).  depth[n] out; returns number of levels.
// lower != 0: dependencies are cols < row; else cols > row.
// ---------------------------------------------------------------------------
int fasp_level_schedule(int n, const int32_t* indptr, const int32_t* indices,
                        int lower, int32_t* depth) {
    int nlev = 0;
    if (lower) {
        for (int i = 0; i < n; ++i) {
            int32_t d = 0;
            for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                int32_t j = indices[p];
                if (j < i && depth[j] + 1 > d) d = depth[j] + 1;
            }
            depth[i] = d;
            if (d + 1 > nlev) nlev = d + 1;
        }
    } else {
        for (int i = n - 1; i >= 0; --i) {
            int32_t d = 0;
            for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                int32_t j = indices[p];
                if (j > i && depth[j] + 1 > d) d = depth[j] + 1;
            }
            depth[i] = d;
            if (d + 1 > nlev) nlev = d + 1;
        }
    }
    return nlev;
}

// ---------------------------------------------------------------------------
// Greedy pairwise matching aggregation (reference: aggregation_symmpair,
// PreAMGAggregationUA.inl:363).  Matches each unaggregated node with its
// strongest-negative unmatched neighbour.  agg[n] out (aggregate id per
// node); returns number of aggregates.
// ---------------------------------------------------------------------------
int fasp_pairwise_match(int n, const int32_t* indptr, const int32_t* indices,
                        const double* data, int32_t* agg) {
    for (int i = 0; i < n; ++i) agg[i] = -1;
    int nagg = 0;
    for (int i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        int best = -1;
        double bestv = 0.0;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int32_t j = indices[p];
            if (j == i || agg[j] != -1) continue;
            double v = data[p];
            if (v < bestv) { bestv = v; best = j; }
        }
        agg[i] = nagg;
        if (best >= 0) agg[best] = nagg;
        ++nagg;
    }
    return nagg;
}

// ---------------------------------------------------------------------------
// VMB greedy aggregation on a strength graph (reference: aggregation_vmb,
// PreAMGAggregation.inl:368).  S is the strength adjacency (no diagonal);
// sdata its weights.  agg[n] out; returns number of aggregates.
// ---------------------------------------------------------------------------
int fasp_vmb_aggregate(int n, const int32_t* indptr, const int32_t* indices,
                       const double* sdata, int max_agg, int32_t* agg) {
    for (int i = 0; i < n; ++i) agg[i] = -1;
    int nagg = 0;
    std::vector<int32_t> count;
    // pass 1: fully-free strong neighborhoods become aggregates
    for (int i = 0; i < n; ++i) {
        if (agg[i] != -1 || indptr[i] == indptr[i + 1]) continue;
        bool all_free = true;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
            if (agg[indices[p]] != -1) { all_free = false; break; }
        if (!all_free) continue;
        agg[i] = nagg;
        int taken = 1;
        for (int32_t p = indptr[i]; p < indptr[i + 1] && taken < max_agg; ++p) {
            agg[indices[p]] = nagg;
            ++taken;
        }
        count.push_back(taken);
        ++nagg;
    }
    // pass 2: attach to strongest neighbouring aggregate with room
    for (int i = 0; i < n; ++i) {
        if (agg[i] != -1 || indptr[i] == indptr[i + 1]) continue;
        int best = -1;
        double bestv = -1.0;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int32_t a = agg[indices[p]];
            if (a >= 0 && count[a] < max_agg && std::fabs(sdata[p]) > bestv) {
                bestv = std::fabs(sdata[p]);
                best = a;
            }
        }
        if (best >= 0) { agg[i] = best; ++count[best]; }
    }
    // pass 3: leftovers group with their free strong neighbours
    for (int i = 0; i < n; ++i) {
        if (agg[i] != -1 || indptr[i] == indptr[i + 1]) continue;
        agg[i] = nagg;
        int taken = 1;
        for (int32_t p = indptr[i]; p < indptr[i + 1] && taken < max_agg; ++p) {
            int32_t j = indices[p];
            if (agg[j] == -1) { agg[j] = nagg; ++taken; }
        }
        count.push_back(taken);
        ++nagg;
    }
    // isolated nodes become singletons
    for (int i = 0; i < n; ++i)
        if (agg[i] == -1) { agg[i] = nagg; ++nagg; }
    return nagg;
}

// ---------------------------------------------------------------------------
// ILU(k): symbolic level-of-fill + numeric IKJ factorization
// (reference: fasp_symbfactor + fasp_iluk, BlaILU.c:72).
//
// Outputs CSR L (unit diagonal stored) and U (diagonal stored).
// l_cap / u_cap are the capacities of the index/data buffers.
// Returns 0 on success, -1 on capacity overflow (caller: grow + retry),
// -2 on zero pivot structurally skipped (factorization continues, like the
// reference which guards ukk==0).
// ---------------------------------------------------------------------------
int fasp_iluk(int n, const int32_t* indptr, const int32_t* indices,
              const double* data, int lfil,
              int32_t* l_indptr, int32_t* l_indices, double* l_data,
              int64_t l_cap,
              int32_t* u_indptr, int32_t* u_indices, double* u_data,
              int64_t u_cap) {
    // per-row U patterns with levels, kept for the whole factorization
    std::vector<std::vector<int32_t>> ucols(n);
    std::vector<std::vector<int32_t>> ulevs(n);
    std::vector<std::vector<double>> uvals(n);

    std::vector<int32_t> pos(n, -1);     // col -> slot in w
    std::vector<int32_t> wcols;          // active columns of row i
    std::vector<int32_t> wlevs;
    std::vector<double> wvals;

    int64_t lnnz = 0, unnz = 0;
    l_indptr[0] = 0;
    u_indptr[0] = 0;

    for (int i = 0; i < n; ++i) {
        wcols.clear(); wlevs.clear(); wvals.clear();
        auto add = [&](int32_t j, int32_t lev, double v) {
            pos[j] = (int32_t)wcols.size();
            wcols.push_back(j); wlevs.push_back(lev); wvals.push_back(v);
        };
        bool has_diag = false;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            add(indices[p], 0, data[p]);
            if (indices[p] == i) has_diag = true;
        }
        if (!has_diag) add(i, 0, 0.0);

        // eliminate lower columns in ascending order
        std::set<int32_t> lower;
        for (int32_t j : wcols) if (j < i) lower.insert(j);
        while (!lower.empty()) {
            int32_t k = *lower.begin();
            lower.erase(lower.begin());
            int32_t pk = pos[k];
            int32_t lev_ik = wlevs[pk];
            // find U_kk
            const auto& ukc = ucols[k];
            const auto& ukv = uvals[k];
            const auto& ukl = ulevs[k];
            double ukk = 0.0;
            for (size_t q = 0; q < ukc.size(); ++q)
                if (ukc[q] == k) { ukk = ukv[q]; break; }
            if (ukk == 0.0) continue;
            double lik = wvals[pk] / ukk;
            wvals[pk] = lik;
            for (size_t q = 0; q < ukc.size(); ++q) {
                int32_t j = ukc[q];
                if (j <= k) continue;
                int32_t lev_new = lev_ik + ukl[q] + 1;
                int32_t pj = pos[j];
                if (pj >= 0 && (size_t)pj < wcols.size() && wcols[pj] == j) {
                    wvals[pj] -= lik * ukv[q];
                    if (lev_new < wlevs[pj]) wlevs[pj] = lev_new;
                } else if (lev_new <= lfil) {
                    add(j, lev_new, -lik * ukv[q]);
                    if (j < i) lower.insert(j);
                }
            }
        }

        // split into L and U (sorted), store U pattern for later rows
        std::vector<int32_t> order(wcols.size());
        for (size_t q = 0; q < order.size(); ++q) order[q] = (int32_t)q;
        std::sort(order.begin(), order.end(),
                  [&](int32_t a, int32_t b) { return wcols[a] < wcols[b]; });
        for (int32_t q : order) {
            int32_t j = wcols[q];
            if (wlevs[q] > lfil) continue;
            if (j < i) {
                if (lnnz >= l_cap) return -1;
                l_indices[lnnz] = j; l_data[lnnz] = wvals[q]; ++lnnz;
            } else {
                if (unnz >= u_cap) return -1;
                u_indices[unnz] = j; u_data[unnz] = wvals[q]; ++unnz;
                ucols[i].push_back(j);
                ulevs[i].push_back(wlevs[q]);
                uvals[i].push_back(wvals[q]);
            }
        }
        // unit diagonal of L
        if (lnnz >= l_cap) return -1;
        l_indices[lnnz] = i; l_data[lnnz] = 1.0; ++lnnz;
        l_indptr[i + 1] = (int32_t)lnnz;
        u_indptr[i + 1] = (int32_t)unnz;
        // reset pos
        for (int32_t j : wcols) pos[j] = -1;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// ILUt: dual-threshold row factorization (reference: fasp_ilut,
// BlaILU.c:467).  Keeps at most lfil entries per row part beyond the
// original pattern (Saad's ILUT(p, tau)).  Same buffer protocol as iluk.
// ---------------------------------------------------------------------------
int fasp_ilut(int n, const int32_t* indptr, const int32_t* indices,
              const double* data, int lfil, double droptol,
              int32_t* l_indptr, int32_t* l_indices, double* l_data,
              int64_t l_cap,
              int32_t* u_indptr, int32_t* u_indices, double* u_data,
              int64_t u_cap) {
    std::vector<std::vector<int32_t>> ucols(n);
    std::vector<std::vector<double>> uvals(n);
    std::vector<int32_t> pos(n, -1);
    std::vector<int32_t> wcols;
    std::vector<double> wvals;

    int64_t lnnz = 0, unnz = 0;
    l_indptr[0] = 0;
    u_indptr[0] = 0;

    for (int i = 0; i < n; ++i) {
        wcols.clear(); wvals.clear();
        double rownorm = 0.0;
        int nrow = indptr[i + 1] - indptr[i];
        auto add = [&](int32_t j, double v) {
            pos[j] = (int32_t)wcols.size();
            wcols.push_back(j); wvals.push_back(v);
        };
        bool has_diag = false;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            add(indices[p], data[p]);
            rownorm += std::fabs(data[p]);
            if (indices[p] == i) has_diag = true;
        }
        if (!has_diag) add(i, 0.0);
        rownorm /= std::max(nrow, 1);
        double tau = droptol * rownorm;

        std::set<int32_t> lower;
        for (int32_t j : wcols) if (j < i) lower.insert(j);
        while (!lower.empty()) {
            int32_t k = *lower.begin();
            lower.erase(lower.begin());
            int32_t pk = pos[k];
            const auto& ukc = ucols[k];
            const auto& ukv = uvals[k];
            double ukk = 0.0;
            for (size_t q = 0; q < ukc.size(); ++q)
                if (ukc[q] == k) { ukk = ukv[q]; break; }
            if (ukk == 0.0) continue;
            // drop small multipliers by the pre-division magnitude (same
            // units as A, like the reference's tnorm-relative drop rule)
            if (std::fabs(wvals[pk]) < tau) { wvals[pk] = 0.0; continue; }
            double lik = wvals[pk] / ukk;
            wvals[pk] = lik;
            for (size_t q = 0; q < ukc.size(); ++q) {
                int32_t j = ukc[q];
                if (j <= k) continue;
                int32_t pj = pos[j];
                if (pj >= 0 && (size_t)pj < wcols.size() && wcols[pj] == j) {
                    wvals[pj] -= lik * ukv[q];
                } else {
                    double v = -lik * ukv[q];
                    if (std::fabs(v) >= tau) {
                        add(j, v);
                        if (j < i) lower.insert(j);
                    }
                }
            }
        }

        // dropping: keep lfil+original largest in each part
        std::vector<int32_t> lpart, upart;
        double diag = 0.0;
        for (size_t q = 0; q < wcols.size(); ++q) {
            int32_t j = wcols[q];
            double v = wvals[q];
            if (j == i) { diag = v; continue; }
            if (j < i) {
                // L holds unitless multipliers: threshold is droptol itself
                if (std::fabs(v) >= droptol) lpart.push_back((int32_t)q);
            } else {
                if (std::fabs(v) >= tau) upart.push_back((int32_t)q);
            }
        }
        size_t keep = (size_t)std::max(lfil, 1) + (size_t)nrow;
        auto trim = [&](std::vector<int32_t>& part) {
            if (part.size() > keep) {
                std::nth_element(
                    part.begin(), part.begin() + keep, part.end(),
                    [&](int32_t a, int32_t b) {
                        return std::fabs(wvals[a]) > std::fabs(wvals[b]);
                    });
                part.resize(keep);
            }
            std::sort(part.begin(), part.end(),
                      [&](int32_t a, int32_t b) {
                          return wcols[a] < wcols[b];
                      });
        };
        trim(lpart); trim(upart);

        for (int32_t q : lpart) {
            if (lnnz >= l_cap) return -1;
            l_indices[lnnz] = wcols[q]; l_data[lnnz] = wvals[q]; ++lnnz;
        }
        if (lnnz >= l_cap) return -1;
        l_indices[lnnz] = i; l_data[lnnz] = 1.0; ++lnnz;

        if (diag == 0.0) diag = tau != 0.0 ? tau : 1e-12;
        if (unnz >= u_cap) return -1;
        u_indices[unnz] = i; u_data[unnz] = diag; ++unnz;
        ucols[i].push_back(i); uvals[i].push_back(diag);
        for (int32_t q : upart) {
            if (unnz >= u_cap) return -1;
            u_indices[unnz] = wcols[q]; u_data[unnz] = wvals[q]; ++unnz;
            ucols[i].push_back(wcols[q]); uvals[i].push_back(wvals[q]);
        }
        l_indptr[i + 1] = (int32_t)lnnz;
        u_indptr[i + 1] = (int32_t)unnz;
        for (int32_t j : wcols) pos[j] = -1;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// ILUtp: row-wise ILUT with column pivoting (reference: fasp_ilutp,
// BlaILU.c:906 — SPARSKIT ilutp).  Works in permuted column space: at
// step i, columns i and jmax are swapped when |w_jmax| * permtol > |w_i|.
// Emits L (unit diagonal) and U with columns in PERMUTED numbering plus
// perm (new -> old): the factors satisfy L U ~= A P, so the solve is
// y = U^-1 L^-1 b, x = P y (x[perm[j]] = y[j]).  Returns 0, or -1 when a
// cap overflows.
// ---------------------------------------------------------------------------
int fasp_ilutp(int n, const int32_t* indptr, const int32_t* indices,
               const double* data, int lfil, double droptol, double permtol,
               int mbloc,
               int32_t* l_indptr, int32_t* l_indices, double* l_data,
               int64_t l_cap,
               int32_t* u_indptr, int32_t* u_indices, double* u_data,
               int64_t u_cap, int32_t* perm_out) {
    // row storage for BOTH factors: later pivots relabel U columns of
    // earlier rows, so the CSR outputs are emitted only after the loop
    std::vector<std::vector<int32_t>> ucols(n), lcols(n);
    std::vector<std::vector<double>> uvals(n), lvals(n);
    std::vector<int32_t> pos(n, -1);
    std::vector<int32_t> wcols;
    std::vector<double> wvals;
    std::vector<int32_t> perm(n), iperm(n);
    for (int i = 0; i < n; ++i) { perm[i] = i; iperm[i] = i; }
    if (mbloc <= 0) mbloc = n;

    for (int i = 0; i < n; ++i) {
        wcols.clear(); wvals.clear();
        double rownorm = 0.0;
        const int nrow = indptr[i + 1] - indptr[i];
        auto add = [&](int32_t j, double v) {
            pos[j] = (int32_t)wcols.size();
            wcols.push_back(j); wvals.push_back(v);
        };
        // load row i with columns mapped old -> new (permuted space)
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            add(iperm[indices[p]], data[p]);
            rownorm += std::fabs(data[p]);
        }
        if (pos[i] < 0) add(i, 0.0);
        rownorm /= std::max(nrow, 1);
        const double tau = droptol * rownorm;

        std::set<int32_t> lower;
        for (int32_t j : wcols) if (j < i) lower.insert(j);
        while (!lower.empty()) {
            const int32_t k = *lower.begin();
            lower.erase(lower.begin());
            const int32_t pk = pos[k];
            const auto& ukc = ucols[k];
            const auto& ukv = uvals[k];
            double ukk = 0.0;
            for (size_t q = 0; q < ukc.size(); ++q)
                if (ukc[q] == k) { ukk = ukv[q]; break; }
            if (ukk == 0.0) continue;
            if (std::fabs(wvals[pk]) < tau) { wvals[pk] = 0.0; continue; }
            const double lik = wvals[pk] / ukk;
            wvals[pk] = lik;
            for (size_t q = 0; q < ukc.size(); ++q) {
                const int32_t j = ukc[q];
                if (j <= k) continue;
                const int32_t pj = pos[j];
                if (pj >= 0 && (size_t)pj < wcols.size() && wcols[pj] == j) {
                    wvals[pj] -= lik * ukv[q];
                } else {
                    const double v = -lik * ukv[q];
                    if (std::fabs(v) >= tau) {
                        add(j, v);
                        if (j < i) lower.insert(j);
                    }
                }
            }
        }

        // pivot search among U-part columns inside i's mbloc block
        double diag = (pos[i] >= 0) ? wvals[pos[i]] : 0.0;
        if (permtol > 0.0) {
            const int32_t bend = ((i / mbloc) + 1) * mbloc;
            int32_t jmax = i;
            double vmax = std::fabs(diag);
            for (size_t q = 0; q < wcols.size(); ++q) {
                const int32_t j = wcols[q];
                if (j > i && j < bend
                    && std::fabs(wvals[q]) * permtol > vmax) {
                    vmax = std::fabs(wvals[q]);
                    jmax = j;
                }
            }
            if (jmax != i) {
                // swap columns i <-> jmax in the permutation and in w
                const int32_t oi = perm[i], oj = perm[jmax];
                perm[i] = oj; perm[jmax] = oi;
                iperm[oj] = i; iperm[oi] = jmax;
                const int32_t pi = pos[i], pj = pos[jmax];
                std::swap(wcols[pi], wcols[pj]);   // both slots keep values
                std::swap(pos[i], pos[jmax]);
                diag = wvals[pos[i]];
                // NOTE: previously-stored U rows keep their (now stale)
                // column numbering for columns >= i only when untouched;
                // SPARSKIT restricts pivoting so columns < i are final —
                // columns i/jmax are both >= i here, and earlier U rows
                // referencing jmax would be mislabeled.  Mirror SPARSKIT:
                // relabel them lazily via a global pass at the end is
                // wrong for the elimination above, so instead walk the
                // earlier rows' U entries now.  Rows are short (<= lfil),
                // and pivoting is rare (permtol-gated), so this stays
                // cheap in practice.
                for (int r = 0; r < i; ++r) {
                    auto& rc = ucols[r];
                    for (size_t q = 0; q < rc.size(); ++q) {
                        if (rc[q] == i) rc[q] = jmax;
                        else if (rc[q] == jmax) rc[q] = i;
                    }
                }
            }
        }

        // dual truncation, same rule as fasp_ilut
        std::vector<int32_t> lpart, upart;
        for (size_t q = 0; q < wcols.size(); ++q) {
            const int32_t j = wcols[q];
            const double v = wvals[q];
            if (j == i) continue;
            if (j < i) {
                if (std::fabs(v) >= droptol) lpart.push_back((int32_t)q);
            } else {
                if (std::fabs(v) >= tau) upart.push_back((int32_t)q);
            }
        }
        const size_t keep = (size_t)std::max(lfil, 1) + (size_t)nrow;
        auto trim = [&](std::vector<int32_t>& part) {
            if (part.size() > keep) {
                std::nth_element(
                    part.begin(), part.begin() + keep, part.end(),
                    [&](int32_t a, int32_t b) {
                        return std::fabs(wvals[a]) > std::fabs(wvals[b]);
                    });
                part.resize(keep);
            }
            std::sort(part.begin(), part.end(),
                      [&](int32_t a, int32_t b) {
                          return wcols[a] < wcols[b];
                      });
        };
        trim(lpart); trim(upart);

        for (const int32_t q : lpart) {
            lcols[i].push_back(wcols[q]);
            lvals[i].push_back(wvals[q]);
        }
        lcols[i].push_back(i);
        lvals[i].push_back(1.0);

        if (diag == 0.0) diag = (tau != 0.0) ? tau : 1e-12;
        ucols[i].push_back(i); uvals[i].push_back(diag);
        for (const int32_t q : upart) {
            ucols[i].push_back(wcols[q]); uvals[i].push_back(wvals[q]);
        }
        for (const int32_t j : wcols) pos[j] = -1;
    }

    // emit CSR outputs (U rows now in the FINAL permuted numbering)
    int64_t lnnz = 0, unnz = 0;
    l_indptr[0] = 0;
    u_indptr[0] = 0;
    for (int i = 0; i < n; ++i) {
        for (size_t q = 0; q < lcols[i].size(); ++q) {
            if (lnnz >= l_cap) return -1;
            l_indices[lnnz] = lcols[i][q]; l_data[lnnz] = lvals[i][q]; ++lnnz;
        }
        for (size_t q = 0; q < ucols[i].size(); ++q) {
            if (unnz >= u_cap) return -1;
            u_indices[unnz] = ucols[i][q]; u_data[unnz] = uvals[i][q]; ++unnz;
        }
        l_indptr[i + 1] = (int32_t)lnnz;
        u_indptr[i + 1] = (int32_t)unnz;
    }
    for (int i = 0; i < n; ++i) perm_out[i] = perm[i];
    return 0;
}

// ---------------------------------------------------------------------------
// Small dense helpers for block ILU(0)
// ---------------------------------------------------------------------------
static bool smat_inv(double* a, int nb) {
    // Gauss-Jordan with partial pivoting, in place
    std::vector<int> piv(nb);
    std::vector<double> work(nb * nb);
    for (int c = 0; c < nb * nb; ++c) work[c] = a[c];
    for (int c = 0; c < nb * nb; ++c) a[c] = 0.0;
    for (int c = 0; c < nb; ++c) a[c * nb + c] = 1.0;
    for (int col = 0; col < nb; ++col) {
        int p = col;
        for (int r = col + 1; r < nb; ++r)
            if (std::fabs(work[r * nb + col]) >
                std::fabs(work[p * nb + col])) p = r;
        if (work[p * nb + col] == 0.0) return false;
        if (p != col)
            for (int c = 0; c < nb; ++c) {
                std::swap(work[p * nb + c], work[col * nb + c]);
                std::swap(a[p * nb + c], a[col * nb + c]);
            }
        const double d = 1.0 / work[col * nb + col];
        for (int c = 0; c < nb; ++c) { work[col * nb + c] *= d;
                                       a[col * nb + c] *= d; }
        for (int r = 0; r < nb; ++r) {
            if (r == col) continue;
            const double f = work[r * nb + col];
            if (f == 0.0) continue;
            for (int c = 0; c < nb; ++c) {
                work[r * nb + c] -= f * work[col * nb + c];
                a[r * nb + c] -= f * a[col * nb + c];
            }
        }
    }
    return true;
}

static inline void smat_mul(const double* a, const double* b, double* c,
                            int nb) {
    for (int r = 0; r < nb; ++r)
        for (int col = 0; col < nb; ++col) {
            double s = 0.0;
            for (int k = 0; k < nb; ++k)
                s += a[r * nb + k] * b[k * nb + col];
            c[r * nb + col] = s;
        }
}

// ---------------------------------------------------------------------------
// Block ILU(0) factorization on the BSR pattern (reference:
// fasp_ilu_dbsr_setup, BlaILUSetupBSR.c — block IKJ with nb x nb dense
// ops).  In place on vals (nnzb, nb, nb): after return, blocks with
// col < row hold L_ik (unit-block-diagonal L implied), blocks with
// col >= row hold U.  diaginv (n, nb, nb) out: inverses of the U diagonal
// blocks for the batched device apply.  Requires sorted columns and
// present diagonal blocks.  Returns 0, or -row-1 on singular pivot.
// ---------------------------------------------------------------------------
int fasp_bsr_ilu0(int n, int nb, const int32_t* indptr,
                  const int32_t* indices, double* vals, double* diaginv) {
    const int bb = nb * nb;
    std::vector<int32_t> pos(n, -1);
    std::vector<double> tmp(bb), linv(bb);
    for (int i = 0; i < n; ++i) {
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
            pos[indices[p]] = p;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int32_t k = indices[p];
            if (k >= i) break;           // sorted: lower part first
            // L_ik = A_ik * inv(U_kk)
            for (int c = 0; c < bb; ++c) linv[c] = diaginv[(int64_t)k * bb + c];
            smat_mul(&vals[(int64_t)p * bb], linv.data(), tmp.data(), nb);
            for (int c = 0; c < bb; ++c) vals[(int64_t)p * bb + c] = tmp[c];
            // A_ij -= L_ik * U_kj for j > k in row k's U part
            for (int32_t q = indptr[k]; q < indptr[k + 1]; ++q) {
                const int32_t j = indices[q];
                if (j <= k) continue;
                const int32_t pj = pos[j];
                if (pj < 0) continue;    // ILU(0): outside pattern dropped
                smat_mul(&vals[(int64_t)p * bb], &vals[(int64_t)q * bb],
                         tmp.data(), nb);
                for (int c = 0; c < bb; ++c)
                    vals[(int64_t)pj * bb + c] -= tmp[c];
            }
        }
        // invert the diagonal block
        const int32_t pd = pos[i];
        if (pd < 0) return -i - 1;
        for (int c = 0; c < bb; ++c)
            diaginv[(int64_t)i * bb + c] = vals[(int64_t)pd * bb + c];
        if (!smat_inv(&diaginv[(int64_t)i * bb], nb)) return -i - 1;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
            pos[indices[p]] = -1;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Classical Ruge-Stuben C/F splitting, first pass (reference:
// cfsplitting_cls, PreAMGCoarsenRS.c).  S is the strength graph (CSR,
// "i strongly depends on j"), ST its transpose.  cf[n] out: 1=C, 0=F.
// Returns number of C points.
// ---------------------------------------------------------------------------
int fasp_rs_cf_split(int n, const int32_t* s_indptr, const int32_t* s_indices,
                     const int32_t* st_indptr, const int32_t* st_indices,
                     int32_t* cf) {
    // lambda = |S^T_i| (how many depend on i), bucket-sorted worklist
    std::vector<int64_t> lambda(n);
    for (int i = 0; i < n; ++i)
        lambda[i] = st_indptr[i + 1] - st_indptr[i];
    const int32_t UNDECIDED = -1;
    for (int i = 0; i < n; ++i) cf[i] = UNDECIDED;

    // max-heap of (lambda, node) with lazy updates
    std::priority_queue<std::pair<int64_t, int32_t>> heap;
    for (int i = 0; i < n; ++i) heap.push({lambda[i], i});

    int nc = 0;
    while (!heap.empty()) {
        auto [lam, i] = heap.top();
        heap.pop();
        if (cf[i] != UNDECIDED || lam != lambda[i]) continue;
        if (lambda[i] == 0) { cf[i] = 1; ++nc; continue; }  // isolated -> C
        cf[i] = 1; ++nc;                                     // C point
        // neighbours that depend on i become F
        for (int32_t p = st_indptr[i]; p < st_indptr[i + 1]; ++p) {
            int32_t j = st_indices[p];
            if (cf[j] != UNDECIDED) continue;
            cf[j] = 0;                                       // F point
            // nodes j depends on get more important
            for (int32_t q = s_indptr[j]; q < s_indptr[j + 1]; ++q) {
                int32_t k = s_indices[q];
                if (cf[k] == UNDECIDED) {
                    ++lambda[k];
                    heap.push({lambda[k], k});
                }
            }
        }
        // nodes i depends on get less important; re-push so the lazy
        // heap still holds a live (lambda, k) entry — stale-only entries
        // would be skipped by the lam != lambda[i] check and the node
        // could finish UNDECIDED
        for (int32_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
            int32_t k = s_indices[p];
            if (cf[k] == UNDECIDED && lambda[k] > 0) {
                --lambda[k];
                heap.push({lambda[k], k});
            }
        }
    }
    // safety net: any node never reached through the worklist becomes F
    // when it strongly depends on a C point, C otherwise (mirrors the
    // reference's final sweep in cfsplitting_cls)
    for (int i = 0; i < n; ++i) {
        if (cf[i] != UNDECIDED) continue;
        cf[i] = 1;
        for (int32_t q = s_indptr[i]; q < s_indptr[i + 1]; ++q)
            if (cf[s_indices[q]] == 1) { cf[i] = 0; break; }
        if (cf[i] == 1) ++nc;
    }
    return nc;
}

// ---------------------------------------------------------------------------
// Strength-of-connection graph (reference: strong_couplings,
// PreAMGCoarsenRS.c): S[i][j] present iff a_ij < 0, -a_ij >= theta *
// max_k(-a_ik), and row i is not diagonally dominated (max_row_sum rule).
// Fills s_indptr[n+1] / s_indices (caller sizes s_indices to nnz(A)).
// Returns nnz(S).
// ---------------------------------------------------------------------------
int64_t fasp_strength_graph(int n, const int32_t* indptr,
                            const int32_t* indices, const double* data,
                            double theta, double max_row_sum,
                            int32_t* s_indptr, int32_t* s_indices) {
    // two-pass (count/scan/fill) so rows parallelize; per-row semantics
    // identical to the serial loop: row scale = largest ABSOLUTE
    // off-diagonal (reference: strong_couplings serial branch,
    // PreAMGCoarsenRS.c:324-384); only negative couplings can be strong.
    std::vector<int32_t> cnt((size_t)n, 0);
#pragma omp parallel for schedule(static)
    for (int i = 0; i < n; ++i) {
        double row_max = 0.0, offsum = 0.0, diag = 0.0;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int32_t j = indices[p];
            if (j == i) { diag = data[p]; continue; }
            const double v = std::fabs(data[p]);
            if (v > row_max) row_max = v;
            offsum += v;
        }
        // strict <, matching the reference's row_sum < (2-mrs)*|a_ii|
        // with row_sum including the diagonal (ADVICE r4)
        const bool isolated = offsum < (1.0 - max_row_sum) * std::fabs(diag);
        int32_t c = 0;
        if (!isolated && row_max > 0.0) {
            const double cut = std::max(theta * row_max, 1e-300);
            for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
                if (indices[p] != i && -data[p] > cut) ++c;
        }
        cnt[i] = c;
    }
    s_indptr[0] = 0;
    for (int i = 0; i < n; ++i)
        s_indptr[i + 1] = s_indptr[i] + cnt[i];
#pragma omp parallel for schedule(static)
    for (int i = 0; i < n; ++i) {
        if (cnt[i] == 0) continue;
        double row_max = 0.0;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            if (indices[p] == i) continue;
            const double v = std::fabs(data[p]);
            if (v > row_max) row_max = v;
        }
        const double cut = std::max(theta * row_max, 1e-300);
        int32_t at = s_indptr[i];
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
            if (indices[p] != i && -data[p] > cut)
                s_indices[at++] = indices[p];
    }
    return (int64_t)s_indptr[n];
}

// ---------------------------------------------------------------------------
// Classical RS first pass with bucket-list priorities (reference:
// cfsplitting_cls with the linked-list buckets of PreAMGUtil.inl:20-296).
// Computes S^T internally by counting sort.  cf[n] out: 1=C, 0=F.
// Deterministic O(n + nnz); replaces the lazy-heap variant for large n.
// ---------------------------------------------------------------------------
int fasp_rs_cf_split2(int n, const int32_t* s_indptr,
                      const int32_t* s_indices, int32_t* cf) {
    // transpose of S by counting sort
    std::vector<int32_t> st_indptr(n + 1, 0), st_indices(s_indptr[n]);
    for (int64_t p = 0; p < s_indptr[n]; ++p) ++st_indptr[s_indices[p] + 1];
    for (int i = 0; i < n; ++i) st_indptr[i + 1] += st_indptr[i];
    {
        std::vector<int32_t> cursor(st_indptr.begin(), st_indptr.end() - 1);
        for (int i = 0; i < n; ++i)
            for (int32_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p)
                st_indices[cursor[s_indices[p]]++] = i;
    }

    // doubly-linked bucket lists keyed by lambda
    std::vector<int32_t> lambda(n), nxt(n, -1), prv(n, -1);
    int32_t max_lam = 0;
    for (int i = 0; i < n; ++i) {
        lambda[i] = st_indptr[i + 1] - st_indptr[i];
        if (lambda[i] > max_lam) max_lam = lambda[i];
    }
    // head per lambda value; lambda can grow to at most n-1
    std::vector<int32_t> head(n + 2, -1);
    auto detach = [&](int32_t i) {
        if (prv[i] >= 0) nxt[prv[i]] = nxt[i];
        else head[lambda[i]] = nxt[i];
        if (nxt[i] >= 0) prv[nxt[i]] = prv[i];
        prv[i] = nxt[i] = -1;
    };
    auto attach = [&](int32_t i) {
        const int32_t l = lambda[i];
        prv[i] = -1;
        nxt[i] = head[l];
        if (head[l] >= 0) prv[head[l]] = i;
        head[l] = i;
        if (l > max_lam) max_lam = l;
    };
    const int32_t UNDECIDED = -1;
    for (int i = 0; i < n; ++i) cf[i] = UNDECIDED;
    for (int i = 0; i < n; ++i) attach(i);

    int32_t cur = max_lam;
    int remaining = n;
    while (remaining > 0) {
        while (cur > 0 && head[cur] < 0) --cur;
        if (cur <= 0) break;      // only lambda-0 nodes left
        const int32_t i = head[cur];
        detach(i);
        cf[i] = 1;                // C point
        --remaining;
        for (int32_t p = st_indptr[i]; p < st_indptr[i + 1]; ++p) {
            const int32_t j = st_indices[p];
            if (cf[j] != UNDECIDED) continue;
            detach(j);
            cf[j] = 0;            // F point
            --remaining;
            for (int32_t q = s_indptr[j]; q < s_indptr[j + 1]; ++q) {
                const int32_t k = s_indices[q];
                if (cf[k] != UNDECIDED) continue;
                detach(k);
                ++lambda[k];
                attach(k);
                if (lambda[k] > cur) cur = lambda[k];
            }
        }
        for (int32_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
            const int32_t k = s_indices[p];
            if (cf[k] != UNDECIDED || lambda[k] <= 0) continue;
            detach(k);
            --lambda[k];
            attach(k);
        }
    }
    // leftovers (lambda 0): F when strongly depending on a C point,
    // C otherwise (isolated handled by the caller)
    int nc = 0;
    for (int i = 0; i < n; ++i) {
        if (cf[i] == UNDECIDED) {
            cf[i] = 1;
            for (int32_t q = s_indptr[i]; q < s_indptr[i + 1]; ++q)
                if (cf[s_indices[q]] == 1) { cf[i] = 0; break; }
        }
        if (cf[i] == 1) ++nc;
    }
    return nc;
}

// ---------------------------------------------------------------------------
// Ruge-Stuben second pass (reference: cfsplitting_cls pass 2 /
// clean_ff_couplings, PreAMGCoarsenRS.c): every strong F-F pair must share
// a common interpolatory C point; pairs that do not promote the first
// endpoint to C.  cf in/out: 1=C, 0=F, 2=isolated.  Returns #promotions.
// ---------------------------------------------------------------------------
int fasp_rs_ff_pass(int n, const int32_t* s_indptr, const int32_t* s_indices,
                    int32_t* cf) {
    std::vector<int32_t> stamp(n, -1);
    int promoted = 0;
    for (int i = 0; i < n; ++i) {
        if (cf[i] != 0) continue;
        // stamp i's strong C points
        for (int32_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
            const int32_t j = s_indices[p];
            if (cf[j] == 1) stamp[j] = i;
        }
        for (int32_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
            const int32_t j = s_indices[p];
            if (cf[j] != 0) continue;
            bool share = false;
            for (int32_t q = s_indptr[j]; q < s_indptr[j + 1]; ++q) {
                const int32_t k = s_indices[q];
                if (cf[k] == 1 && stamp[k] == i) { share = true; break; }
            }
            if (!share) { cf[i] = 1; ++promoted; break; }
        }
    }
    return promoted;
}

// ---------------------------------------------------------------------------
// Standard / extended(+i) interpolation row kernels (reference:
// interp_STD / interp_EXT, PreAMGInterp.c).  Strong F-F couplings are
// eliminated by substituting the F neighbour's row: the standard rule
// distributes a_ij over j's negative off-diagonals, ext+i only over j's
// coarse neighbours and the point i itself.  Emits COO triplets with
// coarse column indices; returns nnz, or -1 when cap is too small.
// cf: 1=C, 0=F, 2=isolated.
// ---------------------------------------------------------------------------
int fasp_interp_std(int n, const int32_t* indptr, const int32_t* indices,
                    const double* data, const int32_t* cf,
                    const int32_t* s_indptr, const int32_t* s_indices,
                    int ext_mode,
                    int32_t* p_rows, int32_t* p_cols, double* p_vals,
                    int64_t cap) {
    // coarse index map
    std::vector<int32_t> cidx(n, -1);
    int32_t nc = 0;
    for (int i = 0; i < n; ++i)
        if (cf[i] == 1) cidx[i] = nc++;

    // rows are independent: OpenMP over contiguous row chunks with
    // per-thread workspaces + output vectors, stitched in row order (the
    // same fan-out/stitch shape as fasp_rap) — output is byte-identical
    // to the serial loop.
#ifdef _OPENMP
    int nt = omp_get_max_threads();
    if (nt > 8) nt = 8;
    if (n < 4096) nt = 1;
#else
    const int nt = 1;
#endif
    std::vector<std::vector<int32_t>> tr(nt), tc(nt);
    std::vector<std::vector<double>> tv(nt);
    std::vector<int> lo(nt + 1);
    for (int t = 0; t <= nt; ++t)
        lo[t] = (int)((int64_t)n * t / nt);

#pragma omp parallel num_threads(nt)
    {
#ifdef _OPENMP
        const int t = omp_get_thread_num();
#else
        const int t = 0;
#endif
        std::vector<double> w(n, 0.0);       // accumulator row a_hat
        std::vector<int32_t> pos(n, -1);     // position stamp
        std::vector<int32_t> touched;        // touched columns, append order
        std::vector<int8_t> strong(n, 0);    // strong-neighbour flag
        touched.reserve(64);
        std::vector<int32_t>& out_r = tr[t];
        std::vector<int32_t>& out_c = tc[t];
        std::vector<double>& out_v = tv[t];

    for (int i = lo[t]; i < lo[t + 1]; ++i) {
        if (cf[i] == 1) {
            out_r.push_back(i);
            out_c.push_back(cidx[i]);
            out_v.push_back(1.0);
            continue;
        }
        if (cf[i] == 2) continue;        // isolated: no interpolation row

        if (ext_mode == 2) {
            // direct interpolation (reference: interp_DIR): no F-F
            // elimination — split the original row over its strong C set
            for (int32_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p)
                strong[s_indices[p]] = 1;
            double aii = 1.0, sum_neg = 0.0, sum_pos = 0.0;
            double sum_negC = 0.0, sum_posC = 0.0;
            for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                const int32_t j = indices[p];
                const double v = data[p];
                if (j == i) { aii = (v != 0.0) ? v : 1.0; continue; }
                if (v < 0) {
                    sum_neg += v;
                    if (strong[j] && cf[j] == 1) sum_negC += v;
                } else if (v > 0) {
                    sum_pos += v;
                    if (strong[j] && cf[j] == 1) sum_posC += v;
                }
            }
            const double alpha = (sum_negC != 0.0) ? sum_neg / sum_negC : 0.0;
            double beta = 0.0;
            if (sum_posC != 0.0) beta = sum_pos / sum_posC;
            else aii += sum_pos;         // fold positive mass
            if (aii == 0.0) aii = 1.0;
            for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                const int32_t j = indices[p];
                const double v = data[p];
                if (j == i || v == 0.0 || !strong[j] || cf[j] != 1) continue;
                const double coef = (v < 0) ? alpha : beta;
                const double pv = -coef * v / aii;
                if (pv == 0.0) continue;
                out_r.push_back(i);
                out_c.push_back(cidx[j]);
                out_v.push_back(pv);
            }
            for (int32_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p)
                strong[s_indices[p]] = 0;
            continue;
        }

        // load row i into the accumulator
        touched.clear();
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int32_t j = indices[p];
            if (pos[j] < 0) { pos[j] = 1; touched.push_back(j); }
            w[j] += data[p];
        }
        for (int32_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p)
            strong[s_indices[p]] = 1;

        // eliminate strong F-F couplings present in the ORIGINAL row of i
        // (iterate a snapshot: Python twin iterates list(acc.keys()) which
        // at that point is exactly row i's columns)
        const size_t row_cols = touched.size();
        for (size_t tt = 0; tt < row_cols; ++tt) {
            const int32_t j = touched[tt];
            if (j == i || cf[j] != 0 || !strong[j]) continue;
            const double aij = w[j];
            w[j] = 0.0;                 // pop
            double denom = 0.0;
            if (ext_mode) {
                for (int32_t q = indptr[j]; q < indptr[j + 1]; ++q) {
                    const int32_t k = indices[q];
                    if (data[q] < 0 && (cf[k] == 1 || k == i)) denom += data[q];
                }
            } else {
                for (int32_t q = indptr[j]; q < indptr[j + 1]; ++q) {
                    const int32_t k = indices[q];
                    if (k != j && data[q] < 0) denom += data[q];
                }
            }
            if (denom == 0.0) {
                if (pos[i] < 0) { pos[i] = 1; touched.push_back(i); }
                w[i] += aij;
                continue;
            }
            const double wgt = aij / denom;
            for (int32_t q = indptr[j]; q < indptr[j + 1]; ++q) {
                const int32_t k = indices[q];
                const bool keep = ext_mode
                    ? (data[q] < 0 && (cf[k] == 1 || k == i))
                    : (k != j && data[q] < 0);
                if (!keep) continue;
                if (pos[k] < 0) { pos[k] = 1; touched.push_back(k); }
                w[k] += wgt * data[q];
            }
        }

        // split the eliminated row
        double aii = 1.0;
        bool have_diag = false;
        double negsum = 0.0, possum = 0.0, negC = 0.0, posC = 0.0;
        for (const int32_t j : touched) {
            const double v = w[j];
            if (j == i) { aii = v; have_diag = true; continue; }
            if (v == 0.0) continue;
            if (v < 0) {
                negsum += v;
                if (cf[j] == 1) negC += v;
            } else {
                possum += v;
                if (cf[j] == 1) posC += v;
            }
        }
        if (!have_diag) aii = 1.0;
        const double alpha = (negC != 0.0) ? negsum / negC : 0.0;
        double beta = 0.0;
        if (posC != 0.0) beta = possum / posC;
        else aii += possum;             // fold positive mass into diagonal
        if (aii == 0.0) aii = 1.0;

        for (const int32_t j : touched) {
            const double v = w[j];
            if (j != i && v != 0.0 && cf[j] == 1) {
                const double coef = (v < 0) ? alpha : beta;
                const double pv = -coef * v / aii;
                if (pv != 0.0) {
                    out_r.push_back(i);
                    out_c.push_back(cidx[j]);
                    out_v.push_back(pv);
                }
            }
        }

        // reset workspaces
        for (const int32_t j : touched) { w[j] = 0.0; pos[j] = -1; }
        for (int32_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p)
            strong[s_indices[p]] = 0;
    }
    }  // omp parallel

    int64_t nnz = 0;
    for (int t = 0; t < nt; ++t) nnz += (int64_t)tr[t].size();
    if (nnz > cap) return -1;
    int64_t at = 0;
    for (int t = 0; t < nt; ++t) {
        std::memcpy(p_rows + at, tr[t].data(), tr[t].size() * sizeof(int32_t));
        std::memcpy(p_cols + at, tc[t].data(), tc[t].size() * sizeof(int32_t));
        std::memcpy(p_vals + at, tv[t].data(), tv[t].size() * sizeof(double));
        at += (int64_t)tr[t].size();
    }
    return (int)nnz;
}

// ---------------------------------------------------------------------------
// F-point Gauss-Seidel sweeps on A e = 0 with C values pinned to zero
// (reference: fasp_smoother_dcsr_gscr, ItrSmootherCSRcr.c — the
// compatible-relaxation habituation smoother).  marker: 0 = F (updated).
// ---------------------------------------------------------------------------
int fasp_fgs_sweeps(int n, const int32_t* indptr, const int32_t* indices,
                    const double* data, const int32_t* marker, double* e,
                    int sweeps) {
    for (int sw = 0; sw < sweeps; ++sw) {
        for (int i = 0; i < n; ++i) {
            if (marker[i] != 0) continue;
            double acc = 0.0, diag = 1.0;
            for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                const int32_t j = indices[p];
                if (j == i) diag = (data[p] != 0.0) ? data[p] : 1.0;
                else acc += data[p] * e[j];
            }
            e[i] = -acc / diag;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Notay quality-bounded pairwise matching (reference: form_pairwise,
// PreAMGAggregationUA.inl:170 — Napov & Notay 2011).  Matches each
// unaggregated node with the free neighbour minimizing the two-point
// convergence measure mu, pairing only when mu <= k_tg.  On the first pass
// extremely diagonally dominant rows (a_ii >= (k+1)/(k-1) * sum|offdiag|)
// are excluded from matching; the reference drops them from the coarse
// space entirely (G0PT), here they become trailing singleton aggregates —
// equivalent up to an identity coarse row.  Returns the aggregate count.
// ---------------------------------------------------------------------------
static inline double row_diag(const int32_t* indptr, const int32_t* indices,
                              const double* data, int i) {
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
        if (indices[p] == i) return data[p];
    return 0.0;
}

int fasp_notay_match(int n, const int32_t* indptr, const int32_t* indices,
                     const double* data, int first_pass, double k_tg,
                     int32_t* agg) {
    const double SMALL = 1e-20;
    std::vector<double> diag(n), s(n, 0.0), sabs(n, 0.0);
    for (int i = 0; i < n; ++i) diag[i] = row_diag(indptr, indices, data, i);
    for (int i = 0; i < n; ++i)
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
            if (indices[p] != i) {
                s[i] -= data[p];
                sabs[i] += std::fabs(data[p]);
            }
    const int32_t FREE = -1, G0 = -2;
    for (int i = 0; i < n; ++i) agg[i] = FREE;
    if (first_pass && k_tg > 1.0) {
        const double hold = (k_tg + 1.0) / (k_tg - 1.0);
        for (int i = 0; i < n; ++i)
            if (diag[i] >= hold * sabs[i]) agg[i] = G0;
    }
    int nagg = 0;
    for (int i = 0; i < n; ++i) {
        if (agg[i] != FREE) continue;
        double min_mu = 1e300;
        int index = -1;
        const double aii = diag[i];
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int32_t col = indices[p];
            if (col == i || agg[col] != FREE) continue;
            const double aij = data[p];
            const double ajj = diag[col];
            double t1 = aii + s[i] + 2.0 * aij;
            double t2 = ajj + s[col] + 2.0 * aij;
            if (std::fabs(t1) < SMALL) t1 = (t1 >= 0) ? SMALL : -SMALL;
            if (std::fabs(t2) < SMALL) t2 = (t2 >= 0) ? SMALL : -SMALL;
            t2 = 1.0 / t1 + 1.0 / t2;
            if (std::fabs(t2) < SMALL) t2 = (t2 >= 0) ? SMALL : -SMALL;
            const double t3 = std::max(std::fabs(aii - s[i]), SMALL);
            double t4 = std::max(std::fabs(ajj - s[col]), SMALL);
            t4 = -aij + 1.0 / (1.0 / t3 + 1.0 / t4);
            if (std::fabs(t4) < SMALL) t4 = (t4 > 0) ? SMALL : -SMALL;
            const double mu = (-aij + 1.0 / t2) / t4;
            if (mu < min_mu) { min_mu = mu; index = col; }
        }
        agg[i] = nagg;
        if (index >= 0 && min_mu <= k_tg) agg[index] = nagg;
        ++nagg;
    }
    for (int i = 0; i < n; ++i)          // G0 rows -> singletons
        if (agg[i] == G0) agg[i] = nagg++;
    return nagg;
}

// ---------------------------------------------------------------------------
// Non-symmetric pairwise matching, first-pass rule (reference:
// nsympair_1stpass + pair_aggregate_init, PreAMGAggregationUA.inl —
// Napov & Notay 2012).  Uses the symmetrized value -0.5(a_ij+a_ji) and the
// del/sig/eta quality measure; rows with a large positive off-diagonal
// (max > 0.45 a_ii) stay unpaired singletons; extremely diagonally
// dominant rows (a_ii > k/(k-2) * symmetrized |offdiag| sum) are G0.
// Later passes reuse this rule on the coarse matrix (the reference's
// nsympair_2ndpass re-derives the measure on the original matrix; the
// composed-coarse form used here is the same construction symmpair uses).
// ---------------------------------------------------------------------------
int fasp_nsympair_match(int n, const int32_t* indptr, const int32_t* indices,
                        const double* data, int first_pass, double k_tg,
                        int32_t* agg) {
    const double SMALL = 1e-20;
    std::vector<double> diag(n), s(n), colsum(n, 0.0), colmax(n, 0.0),
        abscolsum(n, 0.0);
    std::vector<int8_t> nopair(n, 0);
    for (int i = 0; i < n; ++i) diag[i] = row_diag(indptr, indices, data, i);
    for (int i = 0; i < n; ++i)
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int32_t col = indices[p];
            if (col == i) continue;
            const double aij = data[p];
            colsum[col] += aij;
            colmax[col] = std::max(colmax[col], aij);
            abscolsum[col] += std::fabs(aij);
        }
    const int32_t FREE = -1, G0 = -2;
    const double hold = (k_tg > 2.0) ? k_tg / (k_tg - 2.0) : 1e300;
    for (int i = 0; i < n; ++i) {
        double rowsum = 0.0, rmax = 0.0, absrowsum = 0.0;
        const double aii = diag[i];
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            if (indices[p] == i) continue;
            const double aij = data[p];
            rowsum += aij;
            rmax = std::max(rmax, aij);
            absrowsum += std::fabs(aij);
        }
        rowsum = 0.5 * (colsum[i] + rowsum);
        rmax = std::max(colmax[i], rmax);
        absrowsum = 0.5 * (abscolsum[i] + absrowsum);
        s[i] = -rowsum;
        if (first_pass && aii > hold * absrowsum) {
            agg[i] = G0;
        } else {
            agg[i] = FREE;
            if (rmax > 0.45 * aii) nopair[i] = 1;
        }
    }
    int nagg = 0;
    for (int i = 0; i < n; ++i) {
        if (agg[i] != FREE) continue;
        agg[i] = nagg;
        if (nopair[i]) { ++nagg; continue; }
        int ipair = -1;
        double val = 0.0;
        const double aii = diag[i];
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int32_t col = indices[p];
            if (col == i || agg[col] != FREE || nopair[col]) continue;
            const double aij = data[p];
            const double ajj = diag[col];
            double aji = 0.0;
            for (int32_t q = indptr[col]; q < indptr[col + 1]; ++q)
                if (indices[q] == i) { aji = data[q]; break; }
            double vals = -0.5 * (aij + aji);
            const double rsi = -s[i] + aii;
            const double rsj = -s[col] + ajj;
            const double eta1 = 2.0 * aii, eta2 = 2.0 * ajj;
            const double sig1 = s[i] - vals, sig2 = s[col] - vals;
            const double del1 = (sig1 > 0) ? rsi : rsi + 2.0 * sig1;
            const double del2 = (sig2 > 0) ? rsj : rsj + 2.0 * sig2;
            double mu;
            if (vals > 0.0) {
                const double epsr = 1.49e-8 * vals;
                if (std::fabs(del1) < epsr && std::fabs(del2) < epsr) {
                    mu = (eta1 * eta2) / (vals * (eta1 + eta2));
                } else if (std::fabs(del1) < epsr) {
                    if (del2 < -epsr) continue;
                    mu = (eta1 * eta2) / (vals * (eta1 + eta2));
                } else if (std::fabs(del2) < epsr) {
                    if (del1 < -epsr) continue;
                    mu = (eta1 * eta2) / (vals * (eta1 + eta2));
                } else {
                    const double del12 = del1 + del2;
                    if (del12 < -epsr || del12 == 0.0) continue;
                    mu = vals + del1 * del2 / del12;
                    if (mu <= 0.0) continue;
                    mu = ((eta1 * eta2) / (eta1 + eta2)) / mu;
                }
            } else {
                if (del1 <= 0.0 || del2 <= 0.0) continue;
                const double dsum = del1 + del2;
                if (std::fabs(dsum) < SMALL) continue;
                mu = vals + del1 * del2 / dsum;
                if (mu <= 0.0) continue;
                mu = ((eta1 * eta2) / (eta1 + eta2)) / mu;
            }
            if (mu > k_tg) continue;
            if (ipair == -1 || (mu - val) < -0.06) { ipair = col; val = mu; }
        }
        if (ipair >= 0) agg[ipair] = nagg;
        ++nagg;
    }
    for (int i = 0; i < n; ++i)
        if (agg[i] == G0) agg[i] = nagg++;
    return nagg;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Aggressive-coarsening strength between temporary C points (reference:
// strong_couplings_agg1/agg2, PreAMGCoarsenRS.c): Sh(ci,cj) = 1 iff C point
// i is S-connected to C point j directly, or through >= `path` distinct
// 2-hop paths via F points (agg2: the visited-stamp double-mark trick).
// Output CSR over coarse indices (cp order = ascending fine index).
// Returns nnz(Sh), or -1 if cap exceeded.
// ---------------------------------------------------------------------------
extern "C" int64_t fasp_agg_strength(int n, const int32_t* s_indptr,
                                     const int32_t* s_indices,
                                     const int32_t* cf, int path,
                                     int32_t* sh_indptr,
                                     int32_t* sh_indices, int64_t cap) {
    // coarse index maps
    std::vector<int32_t> cp_index, cp_rindex(n, -1);
    for (int i = 0; i < n; ++i)
        if (cf[i] == 1) {
            cp_rindex[i] = (int32_t)cp_index.size();
            cp_index.push_back(i);
        }
    const int num_c = (int)cp_index.size();

#ifdef _OPENMP
    int nt = omp_get_max_threads();
    if (nt > 8) nt = 8;
    if (num_c < 4096) nt = 1;
#else
    const int nt = 1;
#endif
    std::vector<std::vector<int32_t>> tcols(nt);
    std::vector<int> lo(nt + 1);
    for (int t = 0; t <= nt; ++t)
        lo[t] = (int)((int64_t)num_c * t / nt);
    std::vector<int64_t> tstart(nt + 1, 0);

#pragma omp parallel num_threads(nt)
    {
#ifdef _OPENMP
        const int t = omp_get_thread_num();
#else
        const int t = 0;
#endif
        // visited[cj] stamps: ci+1 = connected, -(ci+1) = one 2-path seen
        std::vector<int64_t> visited(num_c, 0);
        std::vector<int32_t>& out = tcols[t];
        for (int ci = lo[t]; ci < lo[t + 1]; ++ci) {
            const int i = cp_index[ci];
            const size_t row_start = out.size();
            for (int32_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
                const int32_t fj = s_indices[p];
                if (cf[fj] == 1 && fj != i) {
                    const int32_t cj = cp_rindex[fj];
                    if (visited[cj] != ci + 1) {
                        visited[cj] = ci + 1;
                        out.push_back(cj);
                    }
                } else if (cf[fj] == 0) {
                    for (int32_t q = s_indptr[fj]; q < s_indptr[fj + 1];
                         ++q) {
                        const int32_t ck = s_indices[q];
                        if (cf[ck] != 1 || ck == i) continue;
                        const int32_t cck = cp_rindex[ck];
                        if (visited[cck] == ci + 1) continue;
                        if (path < 2 || visited[cck] == -(int64_t)(ci + 1)) {
                            visited[cck] = ci + 1;
                            out.push_back(cck);
                        } else {
                            visited[cck] = -(int64_t)(ci + 1);
                        }
                    }
                }
            }
            // per-row counts ride in sh_indptr (prefix-summed below)
            sh_indptr[ci + 1] = (int32_t)(out.size() - row_start);
        }
    }
    sh_indptr[0] = 0;
    int64_t nnz = 0;
    for (int t = 0; t < nt; ++t) {
        tstart[t] = nnz;
        nnz += (int64_t)tcols[t].size();
    }
    if (nnz > cap) return -1;
    for (int ci = 0; ci < num_c; ++ci)
        sh_indptr[ci + 1] += sh_indptr[ci];
    for (int t = 0; t < nt; ++t)
        std::memcpy(sh_indices + tstart[t], tcols[t].data(),
                    tcols[t].size() * sizeof(int32_t));
    return nnz;
}
