// Copy of pyruhvro_tpu/runtime/native/extract.cpp, unchanged but for the
// module's name (_pyruhvro_torch_extract), so that it never shadows the reference's.
//
// Generic Arrow-native extractor module (_pyruhvro_extract): the
// table-driven twin of the extraction core in extract_core.h, serving
// ANY HostProgram with zero compile latency — the same economics split
// as host_codec.cpp (generic VM) vs hostpath/specialize.py (straight-
// line per-schema modules, which embed their opcode/aux tables and fuse
// this extraction with their generated encoder).
//
// Entry points (hostpath/codec.py glue):
//   encode(ops, coltypes, aux, addr_array, addr_schema, n, checked)
//     -> (blob, offsets[n+1], t_extract_s, t_encode_s) | int status
//   The fused fast path: walk the RecordBatch's validity/offset/data
//   buffers via the Arrow C data interface (GIL released), then run the
//   generic encode VM over the in-memory plan columns — no Python/numpy
//   arrays exist between Arrow and the wire.
//   extract(ops, coltypes, aux, addr_array, addr_schema, n)
//     -> (plan buffers as list[bytes], bound) | int status
//   The differential-test window onto the extraction pass alone.
//
// ``aux`` is one entry per op: None, ("uuid",), ("duration",) or
// ("enum", symbol_bytes...) — the logical-type facts the flat opcode
// table cannot carry (built once per codec in hostpath/codec.py).
#include "extract_core.h"

namespace {

using namespace pyr;

// AuxTables (the parsed ``op_aux`` tuple) now lives in extract_core.h,
// shared with the generic fused-decode entry in host_codec.cpp.

bool parse_ops(PyObject* ops_obj, BufferGuard* guard, const Op** ops,
               size_t* nops) {
  if (!guard->acquire(ops_obj, "ops")) return false;
  if (guard->view.len % sizeof(Op) != 0) {
    PyErr_SetString(PyExc_ValueError,
                    "ops buffer size not a multiple of op size");
    return false;
  }
  *ops = static_cast<const Op*>(guard->view.buf);
  *nops = (size_t)(guard->view.len / sizeof(Op));
  return true;
}

PyObject* py_encode_arrow(PyObject*, PyObject* args) {
  PyObject *ops_obj, *coltypes_obj, *aux_obj;
  unsigned long long addr_a, addr_s;
  Py_ssize_t n;
  int checked = 0, nshards = 1;
  if (!PyArg_ParseTuple(args, "OOOKKn|ii", &ops_obj, &coltypes_obj, &aux_obj,
                        &addr_a, &addr_s, &n, &checked, &nshards))
    return nullptr;
  BufferGuard ops_b;
  const Op* ops;
  size_t nops;
  if (!parse_ops(ops_obj, &ops_b, &ops, &nops)) return nullptr;
  AuxTables at;
  if (!at.parse(aux_obj, nops)) return nullptr;
  VmEncRec rec{ops};
  return encode_arrow_boundary(rec, ops, at.aux.data(), coltypes_obj,
                               (uintptr_t)addr_a, (uintptr_t)addr_s, n,
                               checked, nshards);
}

// shard_stats() -> cumulative shard-runner fan-out counters (clears);
// this module's own pool (each extension compiles its own copy)
PyObject* py_shard_stats(PyObject*, PyObject*) { return shard_stats_py(); }

PyObject* py_extract_arrow(PyObject*, PyObject* args) {
  PyObject *ops_obj, *coltypes_obj, *aux_obj;
  unsigned long long addr_a, addr_s;
  Py_ssize_t n;
  if (!PyArg_ParseTuple(args, "OOOKKn", &ops_obj, &coltypes_obj, &aux_obj,
                        &addr_a, &addr_s, &n))
    return nullptr;
  BufferGuard ops_b;
  const Op* ops;
  size_t nops;
  if (!parse_ops(ops_obj, &ops_b, &ops, &nops)) return nullptr;
  AuxTables at;
  if (!at.parse(aux_obj, nops)) return nullptr;
  return extract_arrow_boundary(ops, at.aux.data(), coltypes_obj,
                                (uintptr_t)addr_a, (uintptr_t)addr_s, n);
}

#ifdef PYRUHVRO_NATIVE_PROF
// prof_drain() -> {"extract.op.<name>" | "vm.encop.<name>": (hits, ns)};
// this module's own counters (each extension compiles its own copy of
// the prof globals), drained by hostpath/codec.py after fused calls
PyObject* py_prof_drain(PyObject*, PyObject*) { return prof::drain_py(); }
#endif

PyMethodDef methods[] = {
#ifdef PYRUHVRO_NATIVE_PROF
    {"prof_drain", py_prof_drain, METH_NOARGS,
     "prof_drain() -> {telemetry_key: (hits, ns)} (clears the counters)"},
#endif
    {"encode", py_encode_arrow, METH_VARARGS,
     "encode(ops, coltypes, aux, addr_array, addr_schema, n, checked=0, "
     "nshards=1) -> (blob, offsets[n+1], t_extract_s, t_encode_s) | "
     "status int"},
    {"extract", py_extract_arrow, METH_VARARGS,
     "extract(ops, coltypes, aux, addr_array, addr_schema, n)"
     " -> (buffers, bound) | status int"},
    {"shard_stats", py_shard_stats, METH_NOARGS,
     "shard_stats() -> {fanouts, shards, shard_s, wall_s, threads} "
     "(clears the counters)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_pyruhvro_torch_extract",
    "Arrow-native extraction + fused encode for the host tier", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__pyruhvro_torch_extract(void) {
  return PyModule_Create(&moduledef);
}
