// Native Orzan diffusion-curve XML scene loader.
//
// The reference's host-side scene pipeline is C++ (rapidxml parse +
// optixHello.cpp:211-515 table building).  This is its native counterpart
// for the TPU framework: a small purpose-built XML reader (no third-party
// code) plus the exact table-building semantics, exported through a C ABI
// consumed via ctypes (scene/native_loader.py).  The Python loader
// (scene/xml_loader.py) implements the identical spec; tests pin the two
// against each other bit-for-bit.
//
// Build: make -C raytracingdiffusioncurves_tpu/scene/native
//
// All geometry is computed in double and stored as float, matching the
// Python/NumPy pipeline so the outputs compare exactly.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal XML subset parser: elements, attributes, nesting. No entities, no
// CDATA, no namespaces — the Orzan files use none of those.
// ---------------------------------------------------------------------------

struct XmlNode {
  std::string name;
  std::unordered_map<std::string, std::string> attrs;
  std::vector<XmlNode> children;

  const XmlNode* child(const char* n) const {
    for (const auto& c : children)
      if (c.name == n) return &c;
    return nullptr;
  }
  double attr(const char* n, double dflt) const {
    auto it = attrs.find(n);
    return it == attrs.end() ? dflt : strtod(it->second.c_str(), nullptr);
  }
  bool has(const char* n) const { return attrs.count(n) != 0; }
};

struct Parser {
  const char* p;
  const char* end;

  explicit Parser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

  void skip_ws() {
    while (p < end && isspace((unsigned char)*p)) p++;
  }

  void skip_misc() {  // comments, doctype, PI
    for (;;) {
      skip_ws();
      if (p + 3 < end && strncmp(p, "<!--", 4) == 0) {
        const char* c = strstr(p + 4, "-->");
        p = c ? c + 3 : end;
      } else if (p < end && p[0] == '<' && p + 1 < end && (p[1] == '!' || p[1] == '?')) {
        while (p < end && *p != '>') p++;
        if (p < end) p++;
      } else {
        return;
      }
    }
  }

  std::string name() {
    const char* s = p;
    while (p < end && (isalnum((unsigned char)*p) || *p == '_' || *p == '-' || *p == ':')) p++;
    return std::string(s, p - s);
  }

  bool parse_element(XmlNode* out) {
    skip_misc();
    if (p >= end || *p != '<') return false;
    p++;  // '<'
    out->name = name();
    // attributes
    for (;;) {
      skip_ws();
      if (p < end && *p == '/') {
        p++;  // self-closing
        if (p < end && *p == '>') p++;
        return true;
      }
      if (p < end && *p == '>') {
        p++;
        break;
      }
      std::string an = name();
      skip_ws();
      if (p < end && *p == '=') p++;
      skip_ws();
      char quote = (p < end) ? *p : '"';
      if (quote == '"' || quote == '\'') {
        p++;
        const char* s = p;
        while (p < end && *p != quote) p++;
        out->attrs[an] = std::string(s, p - s);
        if (p < end) p++;
      }
    }
    // children until matching close tag
    for (;;) {
      skip_misc();
      if (p >= end) return true;
      if (*p == '<' && p + 1 < end && p[1] == '/') {
        p += 2;
        name();  // closing name
        skip_ws();
        if (p < end && *p == '>') p++;
        return true;
      }
      if (*p == '<') {
        out->children.emplace_back();
        if (!parse_element(&out->children.back())) return false;
      } else {
        p++;  // text content: ignored
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Geometry (scene/geometry.py equivalents, double precision)
// ---------------------------------------------------------------------------

struct V2 {
  double x, y;
};

// getBezierTangent (optixHello.cpp:1354-1357)
static V2 bezier_derivative(const V2 p[4], double t) {
  double a0 = -3 * t * t + 6 * t - 3;
  double a1 = 9 * t * t - 12 * t + 3;
  double a2 = -9 * t * t + 6 * t;
  double a3 = 3 * t * t;
  return {a3 * p[3].x + a0 * p[0].x + a1 * p[1].x + a2 * p[2].x,
          a3 * p[3].y + a0 * p[0].y + a1 * p[1].y + a2 * p[2].y};
}

// getEndcapPoints (optixHello.cpp:1360-1369) with exact inverse sqrt
static void endcap_points(V2 endpoint, V2 tan, double size, V2* p1, V2* p2) {
  double inv = 1.0 / std::sqrt(tan.x * tan.x + tan.y * tan.y);
  double c = tan.y * inv;
  double s = -tan.x * inv;
  *p1 = {(-c - s) * size + endpoint.x, (-s + c) * size + endpoint.y};
  *p2 = {(c - s) * size + endpoint.x, (s + c) * size + endpoint.y};
}

// ---------------------------------------------------------------------------
// Scene tables (mirrors scene/xml_loader.py)
// ---------------------------------------------------------------------------

struct AttrBuilder {
  int channels;
  std::vector<int64_t> index;  // (start, count) pairs
  std::vector<float> u;
  std::vector<float> values;  // row-major (n, channels)

  explicit AttrBuilder(int ch) : channels(ch) {}
  void begin_curve() {
    index.push_back((int64_t)u.size());
    index.push_back(0);
  }
  void push(double uu, const float* v) {
    u.push_back((float)uu);
    for (int i = 0; i < channels; i++) values.push_back(v[i]);
    index.back() += 1;
  }
  void push1(double uu, double v) {
    float f = (float)v;
    push(uu, &f);
  }
  float* row(size_t i) { return &values[i * channels]; }
  void bump(int n) { index.back() += n; }
};

struct Scene {
  int width = 0, height = 0;
  std::vector<float> vertices;  // (n_segs, 4, 2)
  std::vector<int32_t> curve_map, curve_index, curve_connect, curve_first_segment,
      curve_segment_count;
  AttrBuilder color_left{3}, color_right{3}, blur{1}, weight{1}, weight_degree{1};
  std::string error;
};

static void read_point(const XmlNode& n, int width, int height, bool save, V2* out) {
  // Round through float32 exactly like the Python loader (_read_point
  // builds a float32 array); downstream double math (endcap tangents) then
  // sees bit-identical inputs in both loaders.
  out->x = (double)(float)(n.attr(save ? "y" : "x", 0.0) - (width / 2));
  out->y = (double)(float)(n.attr(save ? "x" : "y", 0.0) - (height / 2));
}

static void read_color(const XmlNode& n, bool save, float out[3]) {
  // reference parses with atoi (optixHello.cpp:1305-1307)
  out[0] = (float)((int)n.attr(save ? "B" : "R", 0.0) / 255.0);
  out[1] = (float)((int)n.attr("G", 0.0) / 255.0);
  out[2] = (float)((int)n.attr(save ? "R" : "B", 0.0) / 255.0);
}

static double attr_u(const XmlNode& n, bool endcap) {
  return n.attr("globalID", 0.0) / 10.0 + (endcap ? 1.0 : 0.0);
}

static void push_bezier4(Scene& sc, const V2 pts[4]) {
  for (int i = 0; i < 4; i++) {
    sc.vertices.push_back((float)pts[i].x);
    sc.vertices.push_back((float)pts[i].y);
  }
}

static bool build_scene(const XmlNode& root, bool save, double endcap_size,
                        double default_weight_degree, bool suppress_endcaps,
                        Scene& sc) {
  sc.width = (int)root.attr("image_width", 0);
  sc.height = (int)root.attr("image_height", 0);
  int n_segments_total = 0;

  int curve_id = -1;
  for (const auto& curve : root.children) {
    curve_id++;
    const XmlNode* cps = curve.child("control_points_set");
    if (!cps) {
      sc.error = "curve missing control_points_set";
      return false;
    }
    // suppress_endcaps: the reference's USE_ENDCAP=false define — no cap
    // geometry and no +1 knot shift (screencaps/no_cap.png).
    bool use_endcap = !suppress_endcaps && curve.attrs.count("use_endcap") &&
                      curve.attrs.at("use_endcap") == "true";
    sc.curve_connect.push_back(curve.has("connects")
                                   ? (int32_t)strtol(curve.attrs.at("connects").c_str(), nullptr, 10)
                                   : -1);
    sc.curve_first_segment.push_back(n_segments_total);

    std::vector<V2> points(cps->children.size());
    for (size_t i = 0; i < cps->children.size(); i++)
      read_point(cps->children[i], sc.width, sc.height, save, &points[i]);
    int n_interior = ((int)points.size() - 1) / 3;

    int curve_segment = 0;
    auto emit = [&](const V2 p[4]) {
      push_bezier4(sc, p);
      sc.curve_map.push_back(curve_id);
      sc.curve_index.push_back(curve_segment++);
    };

    if (use_endcap) {
      // start cap: tangent at t=1e-3 of the first segment, reversed
      // (optixHello.cpp:229-274); t rounds through float32 like Python's
      // np.float32(1e-3) so the tangent is bit-identical across loaders.
      V2 t = bezier_derivative(&points[0], (double)1e-3f);
      t = {-t.x, -t.y};
      V2 e = points[0], p1, p2;
      endcap_points(e, t, endcap_size, &p1, &p2);
      V2 cap[4] = {e, p1, p2, e};
      emit(cap);
    }
    for (int i = 0; i < n_interior; i++) emit(&points[3 * i]);
    if (use_endcap) {
      V2 t = bezier_derivative(&points[3 * (n_interior - 1)], (double)(float)(1.0 - 1e-3));
      V2 e = points[3 * (n_interior - 1) + 3], p1, p2;
      endcap_points(e, t, endcap_size, &p1, &p2);
      V2 cap[4] = {e, p1, p2, e};
      emit(cap);
    }
    int n_curve_segs = curve_segment;

    // ---- colors (optixHello.cpp:332-410) ----
    AttrBuilder& L = sc.color_left;
    AttrBuilder& R = sc.color_right;
    L.begin_curve();
    R.begin_curve();
    size_t lstart = (size_t)L.index[L.index.size() - 2];
    size_t rstart = (size_t)R.index[R.index.size() - 2];
    if (use_endcap) {
      float z[3] = {0, 0, 0};
      // reserved slots bypass the counted push
      R.u.push_back(0);
      R.u.push_back(1);
      for (int i = 0; i < 6; i++) R.values.push_back(0);
      L.u.push_back(0);
      L.u.push_back(1);
      for (int i = 0; i < 6; i++) L.values.push_back(0);
      (void)z;
    }
    const XmlNode* lset = curve.child("left_colors_set");
    const XmlNode* rset = curve.child("right_colors_set");
    if (!lset || !rset) {
      sc.error = "curve missing color sets";
      return false;
    }
    float col[3];
    for (const auto& n : lset->children) {
      read_color(n, save, col);
      L.push(attr_u(n, use_endcap), col);
    }
    for (const auto& n : rset->children) {
      read_color(n, save, col);
      R.push(attr_u(n, use_endcap), col);
    }
    if (save) {  // trailing color duplication (:370-378)
      double dup_u = n_curve_segs - (use_endcap ? 1 : 0);
      size_t last = R.values.size() / 3 - 1;
      float tmp[3] = {R.row(last)[0], R.row(last)[1], R.row(last)[2]};
      R.push(dup_u, tmp);
      last = L.values.size() / 3 - 1;
      float tmp2[3] = {L.row(last)[0], L.row(last)[1], L.row(last)[2]};
      L.push(dup_u, tmp2);
    }
    if (use_endcap) {  // endcap slot permutation (:382-407)
      auto copy3 = [](float* dst, const float* src) { memcpy(dst, src, 3 * sizeof(float)); };
      copy3(L.row(lstart), L.row(lstart + 2));
      copy3(L.row(lstart + 1), R.row(rstart + 2));
      L.bump(2);
      copy3(R.row(rstart), L.row(lstart + 2));
      copy3(R.row(rstart + 1), R.row(rstart + 2));
      R.bump(2);

      size_t ln = L.values.size() / 3, rn = R.values.size() / 3;
      float a[3], b[3];
      copy3(a, R.row(rn - 1));
      L.push(0, a);  // u fixed below
      copy3(b, L.row(L.values.size() / 3 - 2));
      L.push(0, b);
      L.index.back() -= 2;  // pushes counted; reference bumps by 2 total via y+=2
      L.bump(2);
      (void)ln;
      rn = R.values.size() / 3;
      copy3(a, R.row(rn - 1));
      R.push(0, a);
      size_t ln2 = L.values.size() / 3;
      copy3(b, L.row(ln2 - 3));
      R.push(0, b);
      R.index.back() -= 2;
      R.bump(2);
      // knots (:402-405); the two L pushes above wrote placeholder u=0
      size_t Ru = R.u.size(), Lu = L.u.size();
      R.u[Ru - 2] = (float)(n_curve_segs - 1);
      R.u[Ru - 1] = (float)n_curve_segs;
      L.u[Lu - 2] = (float)(n_curve_segs - 1);
      L.u[Lu - 1] = (float)n_curve_segs;
    }

    // ---- blur (:413-437) ----
    AttrBuilder& B = sc.blur;
    B.begin_curve();
    size_t bstart = (size_t)B.index[B.index.size() - 2];
    if (use_endcap) B.push1(0.0, 0.0);
    const XmlNode* bset = curve.child("blur_points_set");
    if (bset)
      for (const auto& n : bset->children) B.push1(attr_u(n, use_endcap), n.attr("value", 0.0));
    if (use_endcap) {
      B.values[bstart] = B.values[bstart + 1];
      B.push1((double)n_curve_segs, B.values.back());
    }

    // ---- weight (:440-474) ----
    AttrBuilder& W = sc.weight;
    W.begin_curve();
    size_t wstart = (size_t)W.index[W.index.size() - 2];
    const XmlNode* wset = curve.child("weight_set");
    if (wset) {
      if (use_endcap) W.push1(0.0, 0.0);
      for (const auto& n : wset->children) W.push1(attr_u(n, use_endcap), n.attr("w", 0.0));
      if (use_endcap) {
        W.values[wstart] = W.values[wstart + 1];
        W.push1((double)n_curve_segs, W.values.back());
      }
    } else {
      W.push1(0.0, 1.0);
      W.push1((double)n_curve_segs, 1.0);
    }

    // ---- weight degree (:477-511) ----
    AttrBuilder& D = sc.weight_degree;
    D.begin_curve();
    size_t dstart = (size_t)D.index[D.index.size() - 2];
    const XmlNode* dset = curve.child("weight_degree_set");
    if (dset) {
      if (use_endcap) D.push1(0.0, default_weight_degree);
      for (const auto& n : dset->children) D.push1(attr_u(n, use_endcap), n.attr("w", 0.0));
      if (use_endcap) {
        D.values[dstart] = D.values[dstart + 1];
        D.push1((double)n_curve_segs, D.values.back());
      }
    } else {
      D.push1(0.0, default_weight_degree);
      D.push1((double)n_curve_segs, default_weight_degree);
    }

    sc.curve_segment_count.push_back(n_curve_segs);
    n_segments_total += n_curve_segs;
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

struct RtdcAttr {
  const int64_t* index;  // (n_curves * 2)
  const float* u;
  const float* values;
  int64_t n_entries;
  int32_t channels;
};

struct RtdcScene {
  int32_t width, height;
  int64_t n_segments, n_curves;
  const float* vertices;  // (n_segments * 8)
  const int32_t* curve_map;
  const int32_t* curve_index;
  const int32_t* curve_connect;
  const int32_t* curve_first_segment;
  const int32_t* curve_segment_count;
  RtdcAttr color_left, color_right, blur, weight, weight_degree;
  const char* error;  // non-null on failure
  void* impl;
};

static void fill_attr(RtdcAttr* out, AttrBuilder& b) {
  out->index = b.index.data();
  out->u = b.u.data();
  out->values = b.values.data();
  out->n_entries = (int64_t)b.u.size();
  out->channels = b.channels;
}

RtdcScene* rtdc_load_scene(const char* xml_text, int save, double endcap_size,
                           double default_weight_degree, int suppress_endcaps) {
  auto* holder = new Scene();
  auto* out = new RtdcScene();
  memset(out, 0, sizeof(*out));
  out->impl = holder;

  std::string text(xml_text);
  Parser parser(text);
  XmlNode root;
  if (!parser.parse_element(&root)) {
    holder->error = "xml parse error";
    out->error = holder->error.c_str();
    return out;
  }
  if (!build_scene(root, save != 0, endcap_size, default_weight_degree,
                   suppress_endcaps != 0, *holder)) {
    out->error = holder->error.c_str();
    return out;
  }
  Scene& sc = *holder;
  out->width = sc.width;
  out->height = sc.height;
  out->n_segments = (int64_t)sc.curve_map.size();
  out->n_curves = (int64_t)sc.curve_connect.size();
  out->vertices = sc.vertices.data();
  out->curve_map = sc.curve_map.data();
  out->curve_index = sc.curve_index.data();
  out->curve_connect = sc.curve_connect.data();
  out->curve_first_segment = sc.curve_first_segment.data();
  out->curve_segment_count = sc.curve_segment_count.data();
  fill_attr(&out->color_left, sc.color_left);
  fill_attr(&out->color_right, sc.color_right);
  fill_attr(&out->blur, sc.blur);
  fill_attr(&out->weight, sc.weight);
  fill_attr(&out->weight_degree, sc.weight_degree);
  return out;
}

void rtdc_free_scene(RtdcScene* s) {
  if (!s) return;
  delete static_cast<Scene*>(s->impl);
  delete s;
}

}  // extern "C"
