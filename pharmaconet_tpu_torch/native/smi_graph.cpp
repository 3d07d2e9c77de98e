// SMILES -> proxy ligand-graph arrays, one pass over a whole batch.
//
// The docking proxies featurize every SMILES on the host before the GNN
// runs on the device (proxy/data.py smi2graph_list). This parser emits the
// exact arrays mol_to_graph produces (atom class one-hot + chirality +
// charge sign; directed bonds with class one-hot), in the same atom/bond
// order as chem/smiles.py, so the outputs are element-equal (tested
// against the Python path).
//
// Unsupported constructs (explicit H atoms, exotic elements) return
// status=2 for that molecule and the caller runs the Python parser for it;
// malformed SMILES return status=1 (callers map it to the invalid-SMILES
// masking path). Built at first use by native/__init__.py
// (g++ -O3 -std=c++17 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int NUM_ATOM_CLASSES = 10;
constexpr int UNKNOWN_ATOM = 9;
constexpr int NUM_ATOM_FEATURES = 14;  // 10 class + 2 chirality + 2 charge
constexpr int NUM_BOND_FEATURES = 5;

struct Atom {
  int8_t cls;       // ATOM_CLASS bucket
  int8_t chirality; // 0 none, 1 @, 2 @@
  int8_t charge_sign;
  bool aromatic;
};

struct BondRec {
  int32_t a, b;
  int8_t cls;  // 0 single 1 double 2 triple 3 aromatic 4 unknown
};

// ATOM_CLASS = {6:0, 7:1, 8:2, 9:3, 15:4, 16:5, 17:6, 35:7, 53:8}
inline int atom_class_of(int z) {
  switch (z) {
    case 6: return 0;
    case 7: return 1;
    case 8: return 2;
    case 9: return 3;
    case 15: return 4;
    case 16: return 5;
    case 17: return 6;
    case 35: return 7;
    case 53: return 8;
    default: return UNKNOWN_ATOM;
  }
}

// element symbol -> Z for the subset a drug-like SMILES can contain; 0 if
// unknown (-> status 2, python fallback handles the full periodic table)
inline int symbol_to_z(const char* s, int len) {
  if (len == 1) {
    switch (s[0]) {
      case 'H': return 1;
      case 'B': return 5;
      case 'C': return 6;
      case 'N': return 7;
      case 'O': return 8;
      case 'F': return 9;
      case 'P': return 15;
      case 'S': return 16;
      case 'K': return 19;
      case 'I': return 53;
      default: return 0;
    }
  }
  if (len == 2) {
    uint16_t key = (uint16_t(s[0]) << 8) | uint16_t(s[1]);
    switch (key) {
      case ('C' << 8) | 'l': return 17;
      case ('B' << 8) | 'r': return 35;
      case ('S' << 8) | 'i': return 14;
      case ('S' << 8) | 'e': return 34;
      case ('N' << 8) | 'a': return 11;
      case ('L' << 8) | 'i': return 3;
      case ('M' << 8) | 'g': return 12;
      case ('C' << 8) | 'a': return 20;
      case ('Z' << 8) | 'n': return 30;
      case ('F' << 8) | 'e': return 26;
      case ('A' << 8) | 's': return 33;
      default: return 0;
    }
  }
  return 0;
}

inline int bond_class_of(int order, bool aromatic) {
  if (aromatic || order == 4) return 3;
  if (order == 1) return 0;
  if (order == 2) return 1;
  if (order == 3) return 2;
  return 4;
}

struct RingOpen {
  int32_t atom = -1;
  int8_t order = -1;  // -1 = unspecified
};

// returns 0 ok, 1 parse error, 2 unsupported (python fallback)
int parse_one(const char* s, int n, std::vector<Atom>& atoms,
              std::vector<BondRec>& bonds) {
  atoms.clear();
  bonds.clear();
  std::vector<int32_t> stack;
  RingOpen rings[100];
  int prev = -1;
  int pending = -1;  // bond order; -1 = none

  auto add_bond = [&](int a, int b, int order) {
    bool aromatic;
    if (order < 0) {
      aromatic = atoms[a].aromatic && atoms[b].aromatic;
      order = aromatic ? 4 : 1;
    } else {
      aromatic = (order == 4);
    }
    bonds.push_back({int32_t(a), int32_t(b),
                     int8_t(bond_class_of(order, aromatic))});
  };
  auto add_atom = [&](int z, bool aromatic, int charge, int chirality) {
    Atom a;
    a.cls = int8_t(atom_class_of(z));
    a.chirality = int8_t(chirality);
    a.charge_sign = int8_t(charge > 0 ? 1 : (charge < 0 ? -1 : 0));
    a.aromatic = aromatic;
    atoms.push_back(a);
    return int(atoms.size()) - 1;
  };

  int i = 0;
  while (i < n) {
    char c = s[i];
    if (c == '(') {
      if (prev < 0) return 1;
      stack.push_back(prev);
      ++i;
    } else if (c == ')') {
      if (stack.empty()) return 1;
      prev = stack.back();
      stack.pop_back();
      ++i;
    } else if (c == '.') {
      prev = -1;
      ++i;
    } else if (c == '-' || c == '/' || c == '\\') {
      pending = 1;
      ++i;
    } else if (c == '=') {
      pending = 2;
      ++i;
    } else if (c == '#') {
      pending = 3;
      ++i;
    } else if (c == '$' || c == ':') {
      pending = 4;
      ++i;
    } else if ((c >= '0' && c <= '9') || c == '%') {
      int num;
      if (c == '%') {
        if (i + 2 >= n || s[i + 1] < '0' || s[i + 1] > '9' || s[i + 2] < '0' ||
            s[i + 2] > '9')
          return 1;
        num = (s[i + 1] - '0') * 10 + (s[i + 2] - '0');
        i += 3;
      } else {
        num = c - '0';
        ++i;
      }
      if (prev < 0) return 1;
      if (rings[num].atom >= 0) {
        if (rings[num].atom == prev) return 1;
        int order = pending >= 0 ? pending : rings[num].order;
        add_bond(rings[num].atom, prev, order);
        rings[num].atom = -1;
        rings[num].order = -1;
      } else {
        rings[num].atom = prev;
        rings[num].order = int8_t(pending);
      }
      pending = -1;
    } else if (c == '[') {
      int end = -1;
      for (int j = i + 1; j < n; ++j)
        if (s[j] == ']') {
          end = j;
          break;
        }
      if (end < 0) return 1;
      int j = i + 1;
      while (j < end && s[j] >= '0' && s[j] <= '9') ++j;  // isotope
      if (j >= end) return 1;
      bool aromatic = false;
      int z;
      char e0 = s[j];
      if (e0 >= 'a' && e0 <= 'z' &&
          (e0 == 'b' || e0 == 'c' || e0 == 'n' || e0 == 'o' || e0 == 'p' ||
           e0 == 's') &&
          (j + 1 >= end || !(s[j + 1] >= 'a' && s[j + 1] <= 'z'))) {
        char up = char(e0 - 'a' + 'A');
        z = symbol_to_z(&up, 1);
        aromatic = true;
        ++j;
      } else {
        int len = 1;
        if (j + 1 < end && s[j + 1] >= 'a' && s[j + 1] <= 'z') len = 2;
        z = symbol_to_z(s + j, len);
        j += len;
      }
      if (z == 0) return 2;  // unknown element: python fallback
      if (z == 1) return 2;  // explicit H atom: python handles stripping
      int chirality = 0;
      if (j < end && s[j] == '@') {
        chirality = 1;
        ++j;
        if (j < end && s[j] == '@') {
          chirality = 2;
          ++j;
        }
        while (j < end && ((s[j] >= 'A' && s[j] <= 'Z') ||
                           (s[j] >= 'a' && s[j] <= 'z') ||
                           (s[j] >= '0' && s[j] <= '9'))) {
          if (s[j] == 'H') break;
          ++j;
        }
      }
      if (j < end && s[j] == 'H') {  // explicit H count: features ignore it
        ++j;
        while (j < end && s[j] >= '0' && s[j] <= '9') ++j;
      }
      int charge = 0;
      while (j < end && (s[j] == '+' || s[j] == '-')) {
        int sign = s[j] == '+' ? 1 : -1;
        ++j;
        int count = 0;
        bool have = false;
        while (j < end && s[j] >= '0' && s[j] <= '9') {
          count = count * 10 + (s[j] - '0');
          have = true;
          ++j;
        }
        charge += sign * (have ? count : 1);
      }
      if (j != end) return 2;  // leftover bracket tokens: fallback
      int idx = add_atom(z, aromatic, charge, chirality);
      if (prev >= 0) add_bond(prev, idx, pending);
      pending = -1;
      prev = idx;
      i = end + 1;
    } else {
      int idx;
      if (c == 'C' && i + 1 < n && s[i + 1] == 'l') {
        idx = add_atom(17, false, 0, 0);
        i += 2;
      } else if (c == 'B' && i + 1 < n && s[i + 1] == 'r') {
        idx = add_atom(35, false, 0, 0);
        i += 2;
      } else if (c == 'B' || c == 'C' || c == 'N' || c == 'O' || c == 'P' ||
                 c == 'S' || c == 'F' || c == 'I') {
        idx = add_atom(symbol_to_z(&c, 1), false, 0, 0);
        ++i;
      } else if (c == 'b' || c == 'c' || c == 'n' || c == 'o' || c == 'p' ||
                 c == 's') {
        char up = char(c - 'a' + 'A');
        idx = add_atom(symbol_to_z(&up, 1), true, 0, 0);
        ++i;
      } else {
        return 1;
      }
      if (prev >= 0) add_bond(prev, idx, pending);
      pending = -1;
      prev = idx;
    }
  }
  for (int k = 0; k < 100; ++k)
    if (rings[k].atom >= 0) return 1;  // unclosed ring
  if (!stack.empty()) return 1;
  if (atoms.empty()) return 1;
  return 0;
}

}  // namespace

extern "C" {

// Parse n_mols SMILES (concatenated; offsets[n_mols+1] delimit each) into
// flat graph arrays. Returns 0 on success, -1 if cap_v/cap_e too small
// (out[0]/out[1] = required sizes).
int32_t smi2graph_batch(
    const char* text, const int64_t* offsets, int32_t n_mols,
    int32_t* atom_class,    // [cap_v]
    float* atom_features,   // [cap_v * 14]
    int32_t* edge_src, int32_t* edge_dst, int32_t* edge_class,  // [cap_e]
    float* edge_features,   // [cap_e * 5]
    int64_t* v_offsets,     // [n_mols + 1]
    int64_t* e_offsets,     // [n_mols + 1]
    int8_t* status,         // [n_mols]
    int64_t cap_v, int64_t cap_e, int64_t* out) {
  std::vector<Atom> atoms;
  std::vector<BondRec> bonds;
  atoms.reserve(256);
  bonds.reserve(256);
  int64_t v = 0, e = 0;
  v_offsets[0] = 0;
  e_offsets[0] = 0;
  for (int32_t m = 0; m < n_mols; ++m) {
    const char* s = text + offsets[m];
    int len = int(offsets[m + 1] - offsets[m]);
    int rc = parse_one(s, len, atoms, bonds);
    status[m] = int8_t(rc);
    if (rc != 0) {
      v_offsets[m + 1] = v;
      e_offsets[m + 1] = e;
      continue;
    }
    int64_t nv = int64_t(atoms.size()), ne = int64_t(bonds.size());
    if (v + nv > cap_v || e + ne > cap_e) {
      // report total requirement (finish counting without writing)
      int64_t need_v = v + nv, need_e = e + ne;
      for (int32_t m2 = m + 1; m2 < n_mols; ++m2) {
        const char* s2 = text + offsets[m2];
        int len2 = int(offsets[m2 + 1] - offsets[m2]);
        if (parse_one(s2, len2, atoms, bonds) == 0) {
          need_v += int64_t(atoms.size());
          need_e += int64_t(bonds.size());
        }
      }
      out[0] = need_v;
      out[1] = need_e;
      return -1;
    }
    for (int64_t k = 0; k < nv; ++k) {
      const Atom& a = atoms[size_t(k)];
      atom_class[v + k] = a.cls;
      float* f = atom_features + (v + k) * NUM_ATOM_FEATURES;
      std::memset(f, 0, sizeof(float) * NUM_ATOM_FEATURES);
      f[a.cls] = 1.0f;
      if (a.chirality == 2) f[NUM_ATOM_CLASSES + 0] = 1.0f;
      else if (a.chirality == 1) f[NUM_ATOM_CLASSES + 1] = 1.0f;
      if (a.charge_sign > 0) f[NUM_ATOM_CLASSES + 2] = 1.0f;
      else if (a.charge_sign < 0) f[NUM_ATOM_CLASSES + 3] = 1.0f;
    }
    for (int64_t k = 0; k < ne; ++k) {
      const BondRec& b = bonds[size_t(k)];
      edge_src[e + k] = b.a;
      edge_dst[e + k] = b.b;
      edge_class[e + k] = b.cls;
      float* f = edge_features + (e + k) * NUM_BOND_FEATURES;
      std::memset(f, 0, sizeof(float) * NUM_BOND_FEATURES);
      f[b.cls] = 1.0f;
    }
    v += nv;
    e += ne;
    v_offsets[m + 1] = v;
    e_offsets[m + 1] = e;
  }
  out[0] = v;
  out[1] = e;
  return 0;
}

}  // extern "C"
