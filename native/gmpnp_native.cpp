// gmpnp native runtime: mesh/graph preprocessing engine.
//
// The reference leans on dolfin's C++ core for mesh storage, connectivity
// and IO (SURVEY.md §2b).  In this framework the *compute* path is
// jit-compiled JAX; the host-side graph building around it — DOLFIN-XML
// parsing, boundary-facet extraction, vertex adjacency, multicolor
// ordering — is the part that warrants native code: it is O(N log N)
// pointer-chasing work that a Python loop does 100-1000x slower on the
// large meshes this framework targets.
//
// Plain C ABI; consumed from Python via ctypes (gmpnp/native.py).
// All index arrays are int32, coordinates double.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// DOLFIN XML parsing (interval / triangle / tetrahedron meshes)
// ---------------------------------------------------------------------------
// Two-call protocol: first call with null buffers fills counts; second call
// fills the caller-allocated arrays.  Returns dim (1/2/3) or -1 on error.

static const char* find_attr(const char* tag, const char* name) {
    // locate ` name="` inside the tag (word boundary on the left so that
    // e.g. attribute "x" does not match inside "index"); returns pointer
    // past the opening quote
    const char* p = tag;
    size_t n = strlen(name);
    while ((p = strstr(p, name)) != nullptr) {
        bool boundary = (p == tag) ||
            (p[-1] == ' ' || p[-1] == '\t' || p[-1] == '\n' || p[-1] == '<');
        const char* q = p + n;
        while (*q == ' ') q++;
        if (boundary && *q == '=') {
            q++;
            while (*q == ' ') q++;
            if (*q == '"') return q + 1;
        }
        p += n;
    }
    return nullptr;
}

int parse_dolfin_xml(const char* text, int64_t text_len,
                     int32_t* n_verts, int32_t* n_cells,
                     double* points /* n_verts*dim */,
                     int32_t* cells /* n_cells*(dim+1) */) {
    const char* p = strstr(text, "<mesh");
    if (!p) return -1;
    const char* ct = find_attr(p, "celltype");
    if (!ct) return -1;
    int dim;
    const char* cellname;
    if (!strncmp(ct, "interval", 8)) { dim = 1; cellname = "<interval"; }
    else if (!strncmp(ct, "triangle", 8)) { dim = 2; cellname = "<triangle"; }
    else if (!strncmp(ct, "tetrahedron", 11)) { dim = 3; cellname = "<tetrahedron"; }
    else return -1;

    const char* vtag = strstr(p, "<vertices");
    if (!vtag) return -1;
    const char* sz = find_attr(vtag, "size");
    int32_t nv = sz ? (int32_t)atoll(sz) : 0;

    const char* ctag = strstr(p, "<cells");
    if (!ctag) return -1;
    sz = find_attr(ctag, "size");
    int32_t nc = sz ? (int32_t)atoll(sz) : 0;

    *n_verts = nv;
    *n_cells = nc;
    if (!points || !cells) return dim;  // counting pass

    static const char* coord_names[3] = {"x", "y", "z"};
    const char* q = vtag;
    for (int32_t i = 0; i < nv; i++) {
        q = strstr(q, "<vertex");
        if (!q) return -1;
        const char* tag_end = strchr(q, '>');
        const char* idx = find_attr(q, "index");
        int32_t vi = idx ? (int32_t)atoll(idx) : i;
        for (int d = 0; d < dim; d++) {
            const char* a = find_attr(q, coord_names[d]);
            if (!a || a > tag_end) return -1;
            points[(int64_t)vi * dim + d] = strtod(a, nullptr);
        }
        q = tag_end;
    }

    static const char* vattrs[4] = {"v0", "v1", "v2", "v3"};
    int nvc = dim + 1;
    q = ctag;
    for (int32_t i = 0; i < nc; i++) {
        q = strstr(q, cellname);
        if (!q) return -1;
        const char* tag_end = strchr(q, '>');
        const char* idx = find_attr(q, "index");
        int32_t ci = idx ? (int32_t)atoll(idx) : i;
        for (int k = 0; k < nvc; k++) {
            const char* a = find_attr(q, vattrs[k]);
            if (!a || a > tag_end) return -1;
            cells[(int64_t)ci * nvc + k] = (int32_t)atoll(a);
        }
        q = tag_end;
    }
    return dim;
}

// ---------------------------------------------------------------------------
// Boundary facet extraction: facets belonging to exactly one cell
// ---------------------------------------------------------------------------
// Returns the number of boundary facets; facets_out gets (count, fdim)
// vertex indices (cell-local order preserved), owners_out the owning cell.
// Counting pass: pass null outputs.

struct FacetKey {
    int32_t v[3];     // sorted vertex ids (padded with -1)
    int32_t cell;
    int32_t slot;     // index into the unsorted facet list
    bool operator<(const FacetKey& o) const {
        if (v[0] != o.v[0]) return v[0] < o.v[0];
        if (v[1] != o.v[1]) return v[1] < o.v[1];
        return v[2] < o.v[2];
    }
    bool same(const FacetKey& o) const {
        return v[0] == o.v[0] && v[1] == o.v[1] && v[2] == o.v[2];
    }
};

int64_t boundary_facets(const int32_t* cells, int64_t n_cells, int32_t nvc,
                        int32_t* facets_out, int32_t* owners_out) {
    int fdim = nvc - 1;
    std::vector<FacetKey> keys;
    keys.reserve(n_cells * nvc);
    std::vector<int32_t> raw((size_t)n_cells * nvc * fdim);

    int64_t slot = 0;
    for (int64_t c = 0; c < n_cells; c++) {
        for (int k = 0; k < nvc; k++) {
            FacetKey fk;
            fk.v[0] = fk.v[1] = fk.v[2] = -1;
            int j = 0;
            for (int m = 0; m < nvc; m++) {
                if (m == k) continue;
                int32_t vid = cells[c * nvc + m];
                raw[slot * fdim + j] = vid;
                fk.v[j++] = vid;
            }
            std::sort(fk.v, fk.v + fdim);
            fk.cell = (int32_t)c;
            fk.slot = (int32_t)slot;
            keys.push_back(fk);
            slot++;
        }
    }
    std::sort(keys.begin(), keys.end());

    int64_t count = 0;
    for (size_t i = 0; i < keys.size();) {
        size_t j = i + 1;
        while (j < keys.size() && keys[j].same(keys[i])) j++;
        if (j - i == 1) {
            if (facets_out) {
                for (int d = 0; d < fdim; d++)
                    facets_out[count * fdim + d] =
                        raw[(int64_t)keys[i].slot * fdim + d];
                owners_out[count] = keys[i].cell;
            }
            count++;
        }
        i = j;
    }
    return count;
}

// ---------------------------------------------------------------------------
// Vertex adjacency (CSR, sorted, self included) + greedy coloring
// ---------------------------------------------------------------------------
// adjacency: counting pass with null col_out fills offsets (n_verts+1).

int64_t vertex_adjacency_csr(const int32_t* cells, int64_t n_cells,
                             int32_t nvc, int32_t n_verts,
                             int64_t* offsets, int32_t* col_out) {
    std::vector<std::pair<int32_t, int32_t>> edges;
    edges.reserve((size_t)n_cells * nvc * nvc);
    for (int64_t c = 0; c < n_cells; c++)
        for (int a = 0; a < nvc; a++)
            for (int b = 0; b < nvc; b++)
                edges.emplace_back(cells[c * nvc + a], cells[c * nvc + b]);
    std::sort(edges.begin(), edges.end());
    edges.erase(std::unique(edges.begin(), edges.end()), edges.end());

    for (int32_t v = 0; v <= n_verts; v++) offsets[v] = 0;
    for (auto& e : edges) offsets[e.first + 1]++;
    for (int32_t v = 0; v < n_verts; v++) offsets[v + 1] += offsets[v];
    if (col_out) {
        int64_t i = 0;
        for (auto& e : edges) col_out[i++] = e.second;
    }
    return (int64_t)edges.size();
}

int32_t greedy_color(const int64_t* offsets, const int32_t* cols,
                     int32_t n_verts, int32_t* colors) {
    std::vector<int32_t> mark;  // color -> last vertex that used it
    int32_t ncolors = 0;
    for (int32_t v = 0; v < n_verts; v++) colors[v] = -1;
    for (int32_t v = 0; v < n_verts; v++) {
        mark.assign(ncolors, -1);
        for (int64_t i = offsets[v]; i < offsets[v + 1]; i++) {
            int32_t u = cols[i];
            if (u != v && colors[u] >= 0) mark[colors[u]] = v;
        }
        int32_t c = 0;
        while (c < ncolors && mark[c] == v) c++;
        if (c == ncolors) ncolors++;
        colors[v] = c;
    }
    return ncolors;
}

}  // extern "C"
