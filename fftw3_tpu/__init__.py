"""fftw3_tpu — a JAX FFT engine with FFTW3's capability surface.

Built from scratch for JAX/XLA: complex DFTs, real-input/output
transforms, DHT, and all eight DCT/DST kinds, at any size (mixed-radix
Stockham + Rader + Bluestein), batched and multi-dimensional, with an
FFTW-style cost-driven planner, persistent wisdom, and a shard_map-based
distributed tier over device meshes.

See SURVEY.md at the repo root for the mapping to the reference (FFTW 3.3.8).
"""
from . import parallel  # noqa: F401
from .api import (  # noqa: F401
    BACKWARD, ESTIMATE, EXHAUSTIVE, FORWARD, MEASURE, PATIENT, Kind, Plan,
    Problem, alignment_of, alloc_complex, alloc_real, cleanup, cost, dct,
    destroy_plan, dht, dst, estimate_cost, execute, export_wisdom,
    export_wisdom_to_file, fprint_plan, free, malloc,
    export_wisdom_to_filename, export_wisdom_to_string, fft, fft2, fftfreq,
    fftn, fftshift, flops, forget_wisdom, idct, idst, ifft, ifft2, ifftn,
    ifftshift, import_system_wisdom, import_wisdom_from_file,
    import_wisdom_from_filename,
    import_wisdom_from_string, irfft, irfft2, irfftn, plan_dft, plan_dft_1d,
    plan_dft_2d, plan_dft_3d, plan_dft_c2r, plan_dft_c2r_1d, plan_dft_c2r_2d,
    plan_dft_c2r_3d, plan_dft_r2c, plan_dft_r2c_1d, plan_dft_r2c_2d,
    plan_dft_r2c_3d, plan_guru_dft, plan_many_dft, plan_r2r, plan_r2r_1d,
    plan_r2r_2d, plan_r2r_3d, import_wisdom,
    print_plan, rfft, rfft2, rfftfreq, rfftn, set_functional_flags,
    set_timelimit, sprint_plan, version, cc, codelet_optim)
from .guru import plan_guru_dft  # noqa: F401  (iodim-aware; shadows api's)
from .guru import (  # noqa: F401
    ManyPlan, SplitPlan, execute_dft, execute_dft_c2r, execute_dft_r2c,
    execute_r2r, execute_split_dft, execute_split_dft_c2r,
    execute_split_dft_r2c, iodim, iodim64, plan_guru64_dft,
    plan_guru64_dft_c2r, plan_guru64_dft_r2c, plan_guru64_r2r,
    plan_guru64_split_dft, plan_guru64_split_dft_c2r,
    plan_guru64_split_dft_r2c, plan_guru_dft_c2r, plan_guru_dft_r2c,
    plan_guru_r2r, plan_guru_split_dft, plan_guru_split_dft_c2r,
    plan_guru_split_dft_r2c, plan_many_dft_c2r, plan_many_dft_r2c,
    plan_many_r2r)
from .kinds import r2r_kind  # noqa: F401  (fftw_r2r_kind type analog)
from .threads import (  # noqa: F401
    cleanup_threads, init_threads, make_planner_thread_safe,
    plan_with_nthreads, planner_nthreads)
from .planner import the_planner  # noqa: F401
from .ops.dd64 import (  # noqa: F401  (fftwl_/fftwq_ tier: PARITY §2.13)
    DdPlan, DdPlanNd, plan_dft_1d_l, plan_dft_1d_q, plan_dft_l,
    plan_dft_q)

__version__ = "0.1.0"
from . import config  # noqa: F401
from . import harness  # noqa: F401
from . import interfaces  # noqa: F401
