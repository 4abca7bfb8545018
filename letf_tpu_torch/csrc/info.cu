// letf_kernel_info: what the card gives each kernel of the library at its
// launch shape (common.cuh::letf_fill_info): registers a thread, static,
// dynamic and local (spill) bytes, threads a block, resident blocks and
// warps an SM. `which` indexes ops/_build.py::KERNEL_INFO.

extern "C" int letf_info_joint(int* out);
extern "C" int letf_info_window(int* out);
extern "C" int letf_info_compose_strategies(int* out);
extern "C" int letf_info_strategies(int fused, int* out);
extern "C" int letf_info_compose(int* out);
extern "C" int letf_info_gbm(int* out);
extern "C" int letf_info_merge(int* out);
extern "C" int letf_info_wash(int* out);
extern "C" int letf_info_draws(int which, int* out);
extern "C" int letf_info_emit_days(int* out);

extern "C" int letf_kernel_info(int which, int* out) {
  switch (which) {
    case 0: return letf_info_joint(out);
    case 1: return letf_info_window(out);
    case 2: return letf_info_compose_strategies(out);
    case 3: return letf_info_strategies(0, out);
    case 4: return letf_info_strategies(1, out);
    case 5: return letf_info_compose(out);
    case 6: return letf_info_gbm(out);
    case 7: return letf_info_merge(out);
    case 8: return letf_info_wash(out);
    case 9: return letf_info_draws(0, out);
    case 10: return letf_info_draws(1, out);
    case 11: return letf_info_draws(2, out);
    case 12: return letf_info_emit_days(out);
    default: return 1;   // cudaErrorInvalidValue
  }
}
