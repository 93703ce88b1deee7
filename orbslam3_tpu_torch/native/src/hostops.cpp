// CPython extension: C-speed loops over MapPoint/KeyFrame object graphs.
//
// The tracking hot path runs several per-frame loops over ~1k Python objects
// (slot lookups, visibility bookkeeping, VO-match cleanup, the local-map
// covisibility counter — Tracking4.cc:273+ roles).  The math is already
// vectorized through the LandmarkTable; what remains is pure attribute
// traffic, which the interpreter pays ~1 us/object for.  These helpers do the
// identical traversal through the C API (~10x faster); orbslam3_tpu/native/
// hostops.py holds the reference Python fallbacks and the build glue.
//
// All functions run under the GIL and mutate exactly what the Python
// versions mutate.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>
#include <unordered_map>

namespace {

// interned attribute names (module-lifetime)
PyObject *s_table, *s_slot, *s_bad, *s_n_visible, *s_last_frame_seen,
    *s_n_obs, *s_n_found, *s_observations;

bool intern_names() {
  s_table = PyUnicode_InternFromString("_table");
  s_slot = PyUnicode_InternFromString("_slot");
  s_bad = PyUnicode_InternFromString("bad");
  s_n_visible = PyUnicode_InternFromString("n_visible");
  s_last_frame_seen = PyUnicode_InternFromString("last_frame_seen");
  s_n_obs = PyUnicode_InternFromString("n_obs");
  s_n_found = PyUnicode_InternFromString("n_found");
  s_observations = PyUnicode_InternFromString("observations");
  return s_table && s_slot && s_bad && s_n_visible && s_last_frame_seen &&
         s_n_obs && s_n_found && s_observations;
}

// obj.<name> as long; returns `fallback` if the attribute is missing.
// Sets *err on conversion failure.
long attr_long(PyObject *obj, PyObject *name, long fallback, bool *err) {
  PyObject *v = PyObject_GetAttr(obj, name);
  if (!v) {
    PyErr_Clear();
    return fallback;
  }
  long r = PyLong_AsLong(v);
  Py_DECREF(v);
  if (r == -1 && PyErr_Occurred()) *err = true;
  return r;
}

bool attr_true(PyObject *obj, PyObject *name, bool *err) {
  PyObject *v = PyObject_GetAttr(obj, name);
  if (!v) {
    PyErr_Clear();
    return false;
  }
  int r = PyObject_IsTrue(v);
  Py_DECREF(v);
  if (r < 0) *err = true;
  return r > 0;
}

// writable 1-D buffer acquired from a contiguous ndarray the wrapper vets
struct Buf {
  Py_buffer view{};
  bool ok = false;
  Buf(PyObject *o, Py_ssize_t itemsize, Py_ssize_t n) {
    if (PyObject_GetBuffer(o, &view, PyBUF_SIMPLE | PyBUF_WRITABLE) < 0) return;
    if (view.len != itemsize * n) {
      PyErr_SetString(PyExc_ValueError, "hostops: buffer length mismatch");
      return;
    }
    ok = true;
  }
  ~Buf() {
    if (view.obj) PyBuffer_Release(&view);
  }
};

// slots_fill(seq, table, out_int64): out[i] = seq[i]._slot if seq[i]._table
// is table else -1 (missing attributes read as detached).
PyObject *slots_fill(PyObject *, PyObject *args) {
  PyObject *seq_in, *table, *out;
  if (!PyArg_ParseTuple(args, "OOO", &seq_in, &table, &out)) return nullptr;
  PyObject *seq = PySequence_Fast(seq_in, "hostops: expected a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  Buf b(out, 8, n);
  if (!b.ok) {
    Py_DECREF(seq);
    return nullptr;
  }
  int64_t *dst = static_cast<int64_t *>(b.view.buf);
  PyObject **items = PySequence_Fast_ITEMS(seq);
  bool err = false;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *mp = items[i];
    int64_t slot = -1;
    PyObject *t = PyObject_GetAttr(mp, s_table);
    if (!t) {
      PyErr_Clear();
    } else {
      if (t == table) slot = attr_long(mp, s_slot, -1, &err);
      Py_DECREF(t);
    }
    dst[i] = slot;
    if (err) break;
  }
  Py_DECREF(seq);
  if (err) return nullptr;
  Py_RETURN_NONE;
}

// mark_seen(map_points_arr, table, fid, stamp_int64):
//   per non-None mp: bad -> arr[i] = None; else n_visible += 1,
//   last_frame_seen = fid, and stamp[mp._slot] = fid when attached to table.
PyObject *mark_seen(PyObject *, PyObject *args) {
  PyObject *arr, *table, *stamp;
  long long fid;
  if (!PyArg_ParseTuple(args, "OOLO", &arr, &table, &fid, &stamp))
    return nullptr;
  PyObject *seq = PySequence_Fast(arr, "hostops: expected a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  Py_buffer sb{};
  if (PyObject_GetBuffer(stamp, &sb, PyBUF_SIMPLE | PyBUF_WRITABLE) < 0) {
    Py_DECREF(seq);
    return nullptr;
  }
  int64_t *st = static_cast<int64_t *>(sb.buf);
  Py_ssize_t st_n = sb.len / 8;
  PyObject **items = PySequence_Fast_ITEMS(seq);
  PyObject *fid_obj = PyLong_FromLongLong(fid);
  bool err = fid_obj == nullptr;
  for (Py_ssize_t i = 0; i < n && !err; ++i) {
    PyObject *mp = items[i];
    if (mp == Py_None) continue;
    bool isbad = attr_true(mp, s_bad, &err);
    if (err) break;
    if (isbad) {
      if (PySequence_SetItem(arr, i, Py_None) < 0) err = true;
      continue;
    }
    long nv = attr_long(mp, s_n_visible, 0, &err);
    if (err) break;
    PyObject *nv_obj = PyLong_FromLong(nv + 1);
    if (!nv_obj || PyObject_SetAttr(mp, s_n_visible, nv_obj) < 0 ||
        PyObject_SetAttr(mp, s_last_frame_seen, fid_obj) < 0)
      err = true;
    Py_XDECREF(nv_obj);
    if (err) break;
    PyObject *t = PyObject_GetAttr(mp, s_table);
    if (!t) {
      PyErr_Clear();
      continue;
    }
    if (t == table) {
      long slot = attr_long(mp, s_slot, -1, &err);
      if (!err && slot >= 0 && slot < st_n) st[slot] = fid;
    }
    Py_DECREF(t);
  }
  Py_XDECREF(fid_obj);
  PyBuffer_Release(&sb);
  Py_DECREF(seq);
  if (err) return nullptr;
  Py_RETURN_NONE;
}

// clean_vo(map_points_arr, outlier_u8): mp with n_obs < 1 -> outlier[i] = 0,
// arr[i] = None  (Tracking "clean VO matches" role).
PyObject *clean_vo(PyObject *, PyObject *args) {
  PyObject *arr, *outlier;
  if (!PyArg_ParseTuple(args, "OO", &arr, &outlier)) return nullptr;
  PyObject *seq = PySequence_Fast(arr, "hostops: expected a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  Buf b(outlier, 1, n);
  if (!b.ok) {
    Py_DECREF(seq);
    return nullptr;
  }
  uint8_t *out = static_cast<uint8_t *>(b.view.buf);
  PyObject **items = PySequence_Fast_ITEMS(seq);
  bool err = false;
  for (Py_ssize_t i = 0; i < n && !err; ++i) {
    PyObject *mp = items[i];
    if (mp == Py_None) continue;
    if (attr_long(mp, s_n_obs, 0, &err) < 1 && !err) {
      out[i] = 0;
      if (PySequence_SetItem(arr, i, Py_None) < 0) err = true;
    }
  }
  Py_DECREF(seq);
  if (err) return nullptr;
  Py_RETURN_NONE;
}

// count_found(map_points_arr, outlier_u8) -> int:
//   per non-None, non-outlier mp: n_found += 1; count those with n_obs > 0.
PyObject *count_found(PyObject *, PyObject *args) {
  PyObject *arr, *outlier;
  if (!PyArg_ParseTuple(args, "OO", &arr, &outlier)) return nullptr;
  PyObject *seq = PySequence_Fast(arr, "hostops: expected a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  Buf b(outlier, 1, n);
  if (!b.ok) {
    Py_DECREF(seq);
    return nullptr;
  }
  uint8_t *out = static_cast<uint8_t *>(b.view.buf);
  PyObject **items = PySequence_Fast_ITEMS(seq);
  long count = 0;
  bool err = false;
  for (Py_ssize_t i = 0; i < n && !err; ++i) {
    PyObject *mp = items[i];
    if (mp == Py_None || out[i]) continue;
    long nf = attr_long(mp, s_n_found, 0, &err);
    if (err) break;
    PyObject *nf_obj = PyLong_FromLong(nf + 1);
    if (!nf_obj || PyObject_SetAttr(mp, s_n_found, nf_obj) < 0) err = true;
    Py_XDECREF(nf_obj);
    if (!err && attr_long(mp, s_n_obs, 0, &err) > 0) ++count;
  }
  Py_DECREF(seq);
  if (err) return nullptr;
  return PyLong_FromLong(count);
}

// count_obs_kfs(map_points_arr) -> dict {kf: n}: covisibility vote counter
// over current-frame points (UpdateLocalKeyFrames first loop).
PyObject *count_obs_kfs(PyObject *, PyObject *args) {
  PyObject *arr;
  if (!PyArg_ParseTuple(args, "O", &arr)) return nullptr;
  PyObject *seq = PySequence_Fast(arr, "hostops: expected a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject **items = PySequence_Fast_ITEMS(seq);
  PyObject *counter = PyDict_New();
  if (!counter) {
    Py_DECREF(seq);
    return nullptr;
  }
  bool err = false;
  for (Py_ssize_t i = 0; i < n && !err; ++i) {
    PyObject *mp = items[i];
    if (mp == Py_None) continue;
    bool isbad = attr_true(mp, s_bad, &err);
    if (err) break;
    if (isbad) continue;
    PyObject *obs = PyObject_GetAttr(mp, s_observations);
    if (!obs) {
      PyErr_Clear();
      continue;
    }
    if (PyDict_Check(obs)) {
      Py_ssize_t pos = 0;
      PyObject *kf, *val;
      while (!err && PyDict_Next(obs, &pos, &kf, &val)) {
        bool kf_bad = attr_true(kf, s_bad, &err);
        if (err) break;
        if (kf_bad) continue;
        PyObject *cur = PyDict_GetItemWithError(counter, kf);  // borrowed
        if (!cur && PyErr_Occurred()) {
          err = true;
          break;
        }
        long c = cur ? PyLong_AsLong(cur) : 0;
        PyObject *nc = PyLong_FromLong(c + 1);
        if (!nc || PyDict_SetItem(counter, kf, nc) < 0) err = true;
        Py_XDECREF(nc);
      }
    }
    Py_DECREF(obs);
  }
  Py_DECREF(seq);
  if (err) {
    Py_DECREF(counter);
    return nullptr;
  }
  return counter;
}

// obs_counts(seq, out_int64): out[i] = len(mp.observations), -1 for
// None/bad points, 0 when the dict is missing/empty.  Returns the total
// over kept (count > 0) points, so the caller can preallocate fill buffers.
PyObject *obs_counts(PyObject *, PyObject *args) {
  PyObject *arr, *out;
  if (!PyArg_ParseTuple(args, "OO", &arr, &out)) return nullptr;
  PyObject *seq = PySequence_Fast(arr, "hostops: expected a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  Buf b(out, 8, n);
  if (!b.ok) {
    Py_DECREF(seq);
    return nullptr;
  }
  int64_t *dst = static_cast<int64_t *>(b.view.buf);
  PyObject **items = PySequence_Fast_ITEMS(seq);
  long long total = 0;
  bool err = false;
  for (Py_ssize_t i = 0; i < n && !err; ++i) {
    PyObject *mp = items[i];
    if (mp == Py_None) {
      dst[i] = -1;
      continue;
    }
    bool isbad = attr_true(mp, s_bad, &err);
    if (err) break;
    if (isbad) {
      dst[i] = -1;
      continue;
    }
    PyObject *obs = PyObject_GetAttr(mp, s_observations);
    if (!obs) {
      PyErr_Clear();
      dst[i] = 0;
      continue;
    }
    dst[i] = PyDict_Check(obs) ? PyDict_Size(obs) : 0;
    Py_DECREF(obs);
    if (dst[i] > 0) total += dst[i];
  }
  Py_DECREF(seq);
  if (err) return nullptr;
  return PyLong_FromLongLong(total);
}

// fill_obs(kept_seq, out_pos_f64(G,3), out_neednorm_u8(G,),
//          out_grp(T,), out_kfi(T,), out_left(T,), out_right(T,)) -> kf_list
// Flattens every kept point's observation dict into parallel arrays in
// iteration order (insertion order, matching the Python loop); distinct
// KeyFrames are interned by identity into the returned list.
PyObject *fill_obs(PyObject *, PyObject *args) {
  PyObject *arr, *pos_o, *needn_o, *grp_o, *kfi_o, *left_o, *right_o;
  if (!PyArg_ParseTuple(args, "OOOOOOO", &arr, &pos_o, &needn_o, &grp_o,
                        &kfi_o, &left_o, &right_o))
    return nullptr;
  PyObject *seq = PySequence_Fast(arr, "hostops: expected a sequence");
  if (!seq) return nullptr;
  Py_ssize_t g_count = PySequence_Fast_GET_SIZE(seq);
  Buf bp(pos_o, 24, g_count), bn(needn_o, 1, g_count);
  Py_buffer gb{}, kb{}, lb{}, rb{};
  bool bufok =
      bp.ok && bn.ok &&
      PyObject_GetBuffer(grp_o, &gb, PyBUF_SIMPLE | PyBUF_WRITABLE) == 0 &&
      PyObject_GetBuffer(kfi_o, &kb, PyBUF_SIMPLE | PyBUF_WRITABLE) == 0 &&
      PyObject_GetBuffer(left_o, &lb, PyBUF_SIMPLE | PyBUF_WRITABLE) == 0 &&
      PyObject_GetBuffer(right_o, &rb, PyBUF_SIMPLE | PyBUF_WRITABLE) == 0;
  PyObject *kf_list = bufok ? PyList_New(0) : nullptr;
  std::unordered_map<PyObject *, int64_t> kf_ids;
  PyObject *s_position = PyUnicode_InternFromString("_position");
  PyObject *s_position_pub = PyUnicode_InternFromString("position");
  PyObject *s_ref_kf = PyUnicode_InternFromString("ref_kf");
  bool err = !bufok || !kf_list || !s_position || !s_ref_kf;
  double *pos = static_cast<double *>(bp.view.buf);
  uint8_t *needn = static_cast<uint8_t *>(bn.view.buf);
  int64_t *grp = static_cast<int64_t *>(gb.buf);
  int64_t *kfi = static_cast<int64_t *>(kb.buf);
  int64_t *left = static_cast<int64_t *>(lb.buf);
  int64_t *right = static_cast<int64_t *>(rb.buf);
  Py_ssize_t cap = err ? 0 : gb.len / 8;
  Py_ssize_t t = 0;
  PyObject **items = err ? nullptr : PySequence_Fast_ITEMS(seq);
  for (Py_ssize_t g = 0; g < g_count && !err; ++g) {
    PyObject *mp = items[g];
    // position: a (3,) float64 ndarray read through the buffer protocol
    // (_position slot on MapPoint; duck-typed stand-ins expose `position`)
    PyObject *p = PyObject_GetAttr(mp, s_position);
    if (!p) {
      PyErr_Clear();
      p = PyObject_GetAttr(mp, s_position_pub);
    }
    if (!p) {
      err = true;
      break;
    }
    Py_buffer pv{};
    if (PyObject_GetBuffer(p, &pv, PyBUF_SIMPLE) < 0 || pv.len != 24) {
      if (pv.obj) {
        PyBuffer_Release(&pv);
        PyErr_SetString(PyExc_ValueError,
                        "hostops: position must be (3,) float64");
      }
      Py_DECREF(p);
      err = true;
      break;
    }
    memcpy(pos + 3 * g, pv.buf, 24);
    PyBuffer_Release(&pv);
    Py_DECREF(p);
    PyObject *ref = PyObject_GetAttr(mp, s_ref_kf);
    if (!ref) PyErr_Clear();
    needn[g] = ref && ref != Py_None;
    Py_XDECREF(ref);
    PyObject *obs = PyObject_GetAttr(mp, s_observations);
    if (!obs) {
      PyErr_Clear();
      continue;
    }
    if (PyDict_Check(obs)) {
      Py_ssize_t pos_it = 0;
      PyObject *kf, *val;
      while (!err && PyDict_Next(obs, &pos_it, &kf, &val)) {
        if (t >= cap) {  // graph mutated between count and fill
          PyErr_SetString(PyExc_RuntimeError, "hostops: obs overflow");
          err = true;
          break;
        }
        auto it = kf_ids.find(kf);
        int64_t ki;
        if (it == kf_ids.end()) {
          ki = PyList_GET_SIZE(kf_list);
          if (PyList_Append(kf_list, kf) < 0) {
            err = true;
            break;
          }
          kf_ids.emplace(kf, ki);
        } else {
          ki = it->second;
        }
        long l = -1, r = -1;
        if (PyTuple_Check(val) && PyTuple_GET_SIZE(val) == 2) {
          l = PyLong_AsLong(PyTuple_GET_ITEM(val, 0));
          r = PyLong_AsLong(PyTuple_GET_ITEM(val, 1));
          if ((l == -1 || r == -1) && PyErr_Occurred()) err = true;
        }
        grp[t] = g;
        kfi[t] = ki;
        left[t] = l;
        right[t] = r;
        ++t;
      }
    }
    Py_DECREF(obs);
  }
  Py_XDECREF(s_position);
  Py_XDECREF(s_position_pub);
  Py_XDECREF(s_ref_kf);
  if (gb.obj) PyBuffer_Release(&gb);
  if (kb.obj) PyBuffer_Release(&kb);
  if (lb.obj) PyBuffer_Release(&lb);
  if (rb.obj) PyBuffer_Release(&rb);
  Py_DECREF(seq);
  if (err) {
    Py_XDECREF(kf_list);
    return nullptr;
  }
  return Py_BuildValue("(Nn)", kf_list, t);
}

// n_obs_of(seq, out_int64): out[i] = mp.n_obs, -1 for None (no bad check —
// matches the `mp is None or mp.n_obs < 1` predicate exactly).
PyObject *n_obs_of(PyObject *, PyObject *args) {
  PyObject *arr, *out;
  if (!PyArg_ParseTuple(args, "OO", &arr, &out)) return nullptr;
  PyObject *seq = PySequence_Fast(arr, "hostops: expected a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  Buf b(out, 8, n);
  if (!b.ok) {
    Py_DECREF(seq);
    return nullptr;
  }
  int64_t *dst = static_cast<int64_t *>(b.view.buf);
  PyObject **items = PySequence_Fast_ITEMS(seq);
  bool err = false;
  for (Py_ssize_t i = 0; i < n && !err; ++i) {
    PyObject *mp = items[i];
    dst[i] = (mp == Py_None) ? -1 : attr_long(mp, s_n_obs, 0, &err);
  }
  Py_DECREF(seq);
  if (err) return nullptr;
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"obs_counts", obs_counts, METH_VARARGS, "observation counts, -1 bad"},
    {"n_obs_of", n_obs_of, METH_VARARGS, "n_obs per entry, -1 for None"},
    {"fill_obs", fill_obs, METH_VARARGS, "flatten observation graphs"},
    {"slots_fill", slots_fill, METH_VARARGS, "fill int64 slots, -1 detached"},
    {"mark_seen", mark_seen, METH_VARARGS, "visibility bookkeeping pass"},
    {"clean_vo", clean_vo, METH_VARARGS, "drop n_obs<1 associations"},
    {"count_found", count_found, METH_VARARGS, "bump n_found, count anchored"},
    {"count_obs_kfs", count_obs_kfs, METH_VARARGS, "covisibility vote counts"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_hostops",
                         "C-speed object-graph loops for the SLAM host path",
                         -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__hostops(void) {
  if (!intern_names()) return nullptr;
  return PyModule_Create(&moduledef);
}
