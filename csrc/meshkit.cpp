// meshkit — native host-side mesh runtime for navier_stokes_tpu.
//
// The reference delegates mesh ingest/partitioning to deal.II C++
// (GridIn::read_msh + GridTools::partition_triangulation,
// /root/reference/src/NavierStokesSolver.cpp:12-21).  This library is the
// equivalent native component for this framework: a fast gmsh parser and
// topology kit for the host-side setup path, where the pure-numpy fallback
// (navier_stokes_tpu/mesh/msh_io.py) becomes the bottleneck at 10M-DoF scale.
//
// Exposed via a plain C ABI consumed with ctypes (no pybind11 in the image).
//
// Build: make -C csrc   ->  csrc/libmeshkit.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct MeshData {
  std::vector<double> coords;       // [n_nodes * 3]
  std::vector<int32_t> cells;       // [n_cells * nodes_per_cell]
  std::vector<int32_t> cell_tags;   // [n_cells]
  std::vector<int32_t> bfacets;     // [n_bf * nodes_per_facet]
  std::vector<int32_t> btags;       // [n_bf]
  int32_t dim = 0;
  std::string error;
};

struct Tokenizer {
  const char* p;
  const char* end;
  explicit Tokenizer(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}
  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) ++p;
  }
  bool next_long(long& out) {
    skip_ws();
    char* q;
    out = strtol(p, &q, 10);
    if (q == p) return false;
    p = q;
    return true;
  }
  bool next_double(double& out) {
    skip_ws();
    char* q;
    out = strtod(p, &q);
    if (q == p) return false;
    p = q;
    return true;
  }
  // position after the line containing the literal `tag`, or nullptr
  const char* find_section(const char* tag) {
    const char* s = p;
    size_t len = strlen(tag);
    while (s < end) {
      const char* hit = static_cast<const char*>(memmem(s, end - s, tag, len));
      if (!hit) return nullptr;
      const char* nl = static_cast<const char*>(memchr(hit, '\n', end - hit));
      return nl ? nl + 1 : end;
    }
    return nullptr;
  }
};

int nodes_of_etype(int etype) {
  switch (etype) {
    case 1: return 2;   // line
    case 2: return 3;   // triangle
    case 4: return 4;   // tetrahedron
    case 15: return 1;  // point
    default: return -1;
  }
}
int dim_of_etype(int etype) {
  switch (etype) {
    case 1: return 1;
    case 2: return 2;
    case 4: return 3;
    case 15: return 0;
    default: return -1;
  }
}

bool parse_v2(const std::string& text, MeshData& md) {
  Tokenizer tk(text);
  const char* nodes_at = tk.find_section("$Nodes");
  if (!nodes_at) { md.error = "no $Nodes"; return false; }
  tk.p = nodes_at;
  long n_nodes;
  if (!tk.next_long(n_nodes)) { md.error = "bad node count"; return false; }
  std::unordered_map<long, int32_t> remap;
  remap.reserve(n_nodes * 2);
  md.coords.resize(n_nodes * 3);
  for (long i = 0; i < n_nodes; ++i) {
    long id; double x, y, z;
    if (!tk.next_long(id) || !tk.next_double(x) || !tk.next_double(y) || !tk.next_double(z)) {
      md.error = "bad node line"; return false;
    }
    remap[id] = static_cast<int32_t>(i);
    md.coords[3 * i] = x; md.coords[3 * i + 1] = y; md.coords[3 * i + 2] = z;
  }

  Tokenizer tk2(text);
  const char* elems_at = tk2.find_section("$Elements");
  if (!elems_at) { md.error = "no $Elements"; return false; }
  tk2.p = elems_at;
  long n_elems;
  if (!tk2.next_long(n_elems)) { md.error = "bad elem count"; return false; }

  struct Elem { int etype; int phys; int32_t nodes[4]; };
  std::vector<Elem> elems;
  elems.reserve(n_elems);
  int max_dim = 0;
  for (long e = 0; e < n_elems; ++e) {
    long id, etype, ntags;
    if (!tk2.next_long(id) || !tk2.next_long(etype) || !tk2.next_long(ntags)) {
      md.error = "bad elem header"; return false;
    }
    long phys = 0;
    for (long t = 0; t < ntags; ++t) {
      long tag; tk2.next_long(tag);
      if (t == 0) phys = tag;
    }
    int nn = nodes_of_etype(static_cast<int>(etype));
    if (nn < 0) { md.error = "unsupported element type " + std::to_string(etype); return false; }
    Elem el{};
    el.etype = static_cast<int>(etype);
    el.phys = static_cast<int>(phys);
    for (int k = 0; k < nn; ++k) {
      long nid; tk2.next_long(nid);
      auto it = remap.find(nid);
      if (it == remap.end()) { md.error = "unknown node id"; return false; }
      el.nodes[k] = it->second;
    }
    int d = dim_of_etype(el.etype);
    if (d > max_dim) max_dim = d;
    elems.push_back(el);
  }
  md.dim = max_dim;
  int cell_nn = (max_dim == 3) ? 4 : 3;
  for (const Elem& el : elems) {
    int d = dim_of_etype(el.etype);
    if (d == max_dim) {
      for (int k = 0; k < cell_nn; ++k) md.cells.push_back(el.nodes[k]);
      md.cell_tags.push_back(el.phys);
    } else if (d == max_dim - 1) {
      for (int k = 0; k < cell_nn - 1; ++k) md.bfacets.push_back(el.nodes[k]);
      md.btags.push_back(el.phys);
    }
  }
  return true;
}

bool parse_v4(const std::string& text, MeshData& md) {
  // Entities: (dim, tag) -> first physical tag
  std::unordered_map<int64_t, int> ent_phys;
  {
    Tokenizer tk(text);
    const char* at = tk.find_section("$Entities");
    if (at) {
      tk.p = at;
      long counts[4];
      for (int d = 0; d < 4; ++d) tk.next_long(counts[d]);
      for (int d = 0; d < 4; ++d) {
        for (long i = 0; i < counts[d]; ++i) {
          long tag; tk.next_long(tag);
          int nbox = (d == 0) ? 3 : 6;
          double dummy;
          for (int b = 0; b < nbox; ++b) tk.next_double(dummy);
          long nphys; tk.next_long(nphys);
          long phys = 0;
          for (long q = 0; q < nphys; ++q) { long v; tk.next_long(v); if (q == 0) phys = v; }
          ent_phys[(static_cast<int64_t>(d) << 32) | static_cast<uint32_t>(tag)] =
              static_cast<int>(phys);
          if (d > 0) {
            long nb; tk.next_long(nb);
            for (long q = 0; q < nb; ++q) { long v; tk.next_long(v); }
          }
        }
      }
    }
  }

  std::unordered_map<long, int32_t> remap;
  {
    Tokenizer tk(text);
    const char* at = tk.find_section("$Nodes");
    if (!at) { md.error = "no $Nodes"; return false; }
    tk.p = at;
    long n_blocks, n_nodes, mn, mx;
    tk.next_long(n_blocks); tk.next_long(n_nodes); tk.next_long(mn); tk.next_long(mx);
    md.coords.resize(n_nodes * 3);
    remap.reserve(n_nodes * 2);
    std::vector<long> ids;
    long k = 0;
    for (long b = 0; b < n_blocks; ++b) {
      long bdim, btag, parametric, nb;
      tk.next_long(bdim); tk.next_long(btag); tk.next_long(parametric); tk.next_long(nb);
      ids.clear();
      for (long i = 0; i < nb; ++i) { long id; tk.next_long(id); ids.push_back(id); }
      long stride = 3 + (parametric ? bdim : 0);
      for (long i = 0; i < nb; ++i) {
        double v[8];
        for (long s = 0; s < stride; ++s) tk.next_double(v[s]);
        remap[ids[i]] = static_cast<int32_t>(k);
        md.coords[3 * k] = v[0]; md.coords[3 * k + 1] = v[1]; md.coords[3 * k + 2] = v[2];
        ++k;
      }
    }
  }

  Tokenizer tk(text);
  const char* at = tk.find_section("$Elements");
  if (!at) { md.error = "no $Elements"; return false; }
  tk.p = at;
  long e_blocks, e_total, mn, mx;
  tk.next_long(e_blocks); tk.next_long(e_total); tk.next_long(mn); tk.next_long(mx);
  struct Elem { int etype; int phys; int32_t nodes[4]; };
  std::vector<Elem> elems;
  elems.reserve(e_total);
  int max_dim = 0;
  for (long b = 0; b < e_blocks; ++b) {
    long edim, etag, etype, nb;
    tk.next_long(edim); tk.next_long(etag); tk.next_long(etype); tk.next_long(nb);
    int nn = nodes_of_etype(static_cast<int>(etype));
    if (nn < 0) { md.error = "unsupported element type " + std::to_string(etype); return false; }
    auto it = ent_phys.find((static_cast<int64_t>(edim) << 32) | static_cast<uint32_t>(etag));
    int phys = (it != ent_phys.end()) ? it->second : 0;
    for (long e = 0; e < nb; ++e) {
      long id; tk.next_long(id);
      Elem el{};
      el.etype = static_cast<int>(etype);
      el.phys = phys;
      for (int q = 0; q < nn; ++q) {
        long nid; tk.next_long(nid);
        el.nodes[q] = remap.at(nid);
      }
      int d = dim_of_etype(el.etype);
      if (d > max_dim) max_dim = d;
      elems.push_back(el);
    }
  }
  md.dim = max_dim;
  int cell_nn = (max_dim == 3) ? 4 : 3;
  for (const Elem& el : elems) {
    int d = dim_of_etype(el.etype);
    if (d == max_dim) {
      for (int q = 0; q < cell_nn; ++q) md.cells.push_back(el.nodes[q]);
      md.cell_tags.push_back(el.phys);
    } else if (d == max_dim - 1) {
      for (int q = 0; q < cell_nn - 1; ++q) md.bfacets.push_back(el.nodes[q]);
      md.btags.push_back(el.phys);
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Parse a .msh file.  Returns an opaque handle (nullptr on open failure).
void* meshkit_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string text(sz, '\0');
  size_t rd = fread(text.data(), 1, sz, f);
  fclose(f);
  text.resize(rd);

  auto* md = new MeshData();
  Tokenizer tk(text);
  const char* fmt = tk.find_section("$MeshFormat");
  if (!fmt) { md->error = "no $MeshFormat"; return md; }
  tk.p = fmt;
  double version; tk.next_double(version);
  bool ok = (version < 3.0) ? parse_v2(text, *md) : parse_v4(text, *md);
  if (!ok && md->error.empty()) md->error = "parse failed";
  return md;
}

const char* meshkit_error(void* h) {
  auto* md = static_cast<MeshData*>(h);
  return md->error.empty() ? nullptr : md->error.c_str();
}

int32_t meshkit_dim(void* h) { return static_cast<MeshData*>(h)->dim; }
int64_t meshkit_n_nodes(void* h) { return static_cast<MeshData*>(h)->coords.size() / 3; }
int64_t meshkit_n_cells(void* h) {
  auto* md = static_cast<MeshData*>(h);
  int nn = (md->dim == 3) ? 4 : 3;
  return md->cells.size() / nn;
}
int64_t meshkit_n_bfacets(void* h) { return static_cast<MeshData*>(h)->btags.size(); }

const double* meshkit_coords(void* h) { return static_cast<MeshData*>(h)->coords.data(); }
const int32_t* meshkit_cells(void* h) { return static_cast<MeshData*>(h)->cells.data(); }
const int32_t* meshkit_cell_tags(void* h) { return static_cast<MeshData*>(h)->cell_tags.data(); }
const int32_t* meshkit_bfacets(void* h) { return static_cast<MeshData*>(h)->bfacets.data(); }
const int32_t* meshkit_btags(void* h) { return static_cast<MeshData*>(h)->btags.data(); }

void meshkit_free(void* h) { delete static_cast<MeshData*>(h); }

// ---- topology: unique edge extraction (the P2 DoF generator) --------------
// cells: [n_cells * npc]; writes unique sorted edges into out_edges
// (caller-allocated, capacity cap pairs) and the per-cell edge ids into
// out_cell_edges [n_cells * epc].  Returns the number of unique edges, or -1
// if cap is too small.
int64_t meshkit_edges(const int32_t* cells, int64_t n_cells, int32_t npc,
                      int32_t* out_edges, int64_t cap, int32_t* out_cell_edges) {
  static const int tri_pairs[3][2] = {{0, 1}, {1, 2}, {2, 0}};
  static const int tet_pairs[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
  const int(*pairs)[2] = (npc == 4) ? tet_pairs : tri_pairs;
  int epc = (npc == 4) ? 6 : 3;

  std::unordered_map<int64_t, int32_t> edge_id;
  edge_id.reserve(n_cells * epc);
  int64_t n_edges = 0;
  for (int64_t c = 0; c < n_cells; ++c) {
    for (int e = 0; e < epc; ++e) {
      int32_t a = cells[c * npc + pairs[e][0]];
      int32_t b = cells[c * npc + pairs[e][1]];
      if (a > b) std::swap(a, b);
      int64_t key = (static_cast<int64_t>(a) << 32) | static_cast<uint32_t>(b);
      auto [it, inserted] = edge_id.emplace(key, static_cast<int32_t>(n_edges));
      if (inserted) {
        if (n_edges >= cap) return -1;
        out_edges[2 * n_edges] = a;
        out_edges[2 * n_edges + 1] = b;
        ++n_edges;
      }
      out_cell_edges[c * epc + e] = it->second;
    }
  }
  return n_edges;
}

}  // extern "C"
