// Record pack on the host: a Python list of datums joined into one flat
// byte buffer with record start offsets, the interpreter lock released
// around the copy, the copy split over hardware threads for large inputs.
//
// Copy of pyruhvro_tpu/runtime/native/packer.cpp: `concat` (:168-226),
// `max_len` (:228-250) and their helpers `collect_spans` and
// `parallel_rows` (:31-86); `pack_padded` is not needed by the port.
// Built at first use by pyruhvro_tpu_torch/runtime/native.py with the
// host compiler (CPython C API, no binding library) and used by the
// decoders on the card path; the CPU path joins with `bytearray().join`.
//
//   concat(data: list[bytes|bytearray|memoryview], out: buffer1d,
//          offsets: buffer_int64) -> total
//       record i's bytes at out[offsets[i], offsets[i+1]); offsets has
//       n+1 slots.
//   max_len(data) -> (max_record_len, total_bytes)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Span {
  const char* ptr;
  Py_ssize_t len;
};

// Collect (ptr, len) for every item while holding the interpreter lock.
// Returns false (with a Python error set) on an item that is not
// bytes-like.
bool collect_spans(PyObject* list, std::vector<Span>& spans,
                   std::vector<Py_buffer>& views) {
  Py_ssize_t n = PySequence_Fast_GET_SIZE(list);
  spans.reserve(static_cast<size_t>(n));
  PyObject** items = PySequence_Fast_ITEMS(list);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = items[i];
    if (PyBytes_Check(item)) {
      spans.push_back({PyBytes_AS_STRING(item), PyBytes_GET_SIZE(item)});
    } else {
      Py_buffer view;
      if (PyObject_GetBuffer(item, &view, PyBUF_SIMPLE) != 0) {
        PyErr_Format(PyExc_TypeError, "item %zd is not bytes-like", i);
        return false;
      }
      views.push_back(view);
      spans.push_back({static_cast<const char*>(view.buf), view.len});
    }
  }
  return true;
}

void release_views(std::vector<Py_buffer>& views) {
  for (auto& v : views) PyBuffer_Release(&v);
}

int num_threads_for(size_t total_bytes) {
  if (total_bytes < (1u << 20)) return 1;  // under 1 MB threads cost more
  unsigned hw = std::thread::hardware_concurrency();
  return static_cast<int>(hw ? (hw > 16 ? 16 : hw) : 4);
}

template <typename Fn>
void parallel_rows(Py_ssize_t n, size_t total_bytes, Fn&& fn) {
  int nt = num_threads_for(total_bytes);
  if (nt <= 1 || n < nt) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  Py_ssize_t per = n / nt;
  for (int t = 0; t < nt; t++) {
    Py_ssize_t a = t * per;
    Py_ssize_t b = (t == nt - 1) ? n : a + per;
    threads.emplace_back([&fn, a, b] { fn(a, b); });
  }
  for (auto& th : threads) th.join();
}

PyObject* concat(PyObject*, PyObject* args) {
  PyObject* data_obj;
  Py_buffer out;
  Py_buffer offsets;
  if (!PyArg_ParseTuple(args, "Ow*w*", &data_obj, &out, &offsets)) {
    return nullptr;
  }
  PyObject* fast = PySequence_Fast(data_obj, "expected a sequence of bytes");
  if (!fast) {
    PyBuffer_Release(&out);
    PyBuffer_Release(&offsets);
    return nullptr;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);

  std::vector<Span> spans;
  std::vector<Py_buffer> views;
  bool ok = collect_spans(fast, spans, views);

  size_t total = 0;
  std::vector<int64_t> offs;
  if (ok) {
    offs.reserve(static_cast<size_t>(n) + 1);
    offs.push_back(0);
    for (auto& s : spans) {
      total += static_cast<size_t>(s.len);
      offs.push_back(static_cast<int64_t>(total));
    }
    if (offsets.len < static_cast<Py_ssize_t>((n + 1) * sizeof(int64_t))) {
      PyErr_SetString(PyExc_ValueError, "offsets buffer too small");
      ok = false;
    } else if (out.len < static_cast<Py_ssize_t>(total)) {
      PyErr_SetString(PyExc_ValueError, "out buffer too small");
      ok = false;
    }
  }

  if (ok) {
    char* out_base = static_cast<char*>(out.buf);
    std::memcpy(offsets.buf, offs.data(), (n + 1) * sizeof(int64_t));
    Py_BEGIN_ALLOW_THREADS
    parallel_rows(n, total, [&](Py_ssize_t a, Py_ssize_t b) {
      for (Py_ssize_t i = a; i < b; i++) {
        const Span& s = spans[static_cast<size_t>(i)];
        if (s.len)
          std::memcpy(out_base + offs[static_cast<size_t>(i)], s.ptr,
                      static_cast<size_t>(s.len));
      }
    });
    Py_END_ALLOW_THREADS
  }

  release_views(views);
  Py_DECREF(fast);
  PyBuffer_Release(&out);
  PyBuffer_Release(&offsets);
  if (!ok) return nullptr;
  return PyLong_FromSize_t(total);
}

PyObject* max_len(PyObject*, PyObject* args) {
  PyObject* data_obj;
  if (!PyArg_ParseTuple(args, "O", &data_obj)) return nullptr;
  PyObject* fast = PySequence_Fast(data_obj, "expected a sequence of bytes");
  if (!fast) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject** items = PySequence_Fast_ITEMS(fast);
  Py_ssize_t best = 0;
  Py_ssize_t total = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    Py_ssize_t len;
    if (PyBytes_Check(items[i])) {
      len = PyBytes_GET_SIZE(items[i]);
    } else {
      len = PyObject_Length(items[i]);
      if (len < 0) {
        Py_DECREF(fast);
        return nullptr;
      }
    }
    if (len > best) best = len;
    total += len;
  }
  Py_DECREF(fast);
  return Py_BuildValue("(nn)", best, total);
}

PyMethodDef methods[] = {
    {"concat", concat, METH_VARARGS,
     "concat(data, out_1d, offsets_i64) -> total_bytes"},
    {"max_len", max_len, METH_VARARGS,
     "max_len(data) -> (max_record_len, total_bytes)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_pyruhvro_torch_packer",
    "Record pack for pyruhvro_tpu_torch (interpreter lock released).",
    -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__pyruhvro_torch_packer(void) {
  return PyModule_Create(&module);
}
