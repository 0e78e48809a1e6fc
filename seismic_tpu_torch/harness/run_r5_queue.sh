#!/bin/bash
# The round-5 measurement queue on the card: the port of
# seismic_tpu/harness/run_r5_tpu_queue.sh, every stage mapped to the
# port's module (python -m seismic_tpu_torch.harness.*).
#
# One card process at a time: queue instances take one lock (flock) and
# wait for each other. Every stage runs under a timeout. Before each
# stage on the card, a bounded check (CARD_CHECK_S seconds, CARD_CHECK_TRIES
# tries) that a CUDA computation makes the round trip; a stage whose check
# fails is logged FAILED with the reason and the queue goes on.
#
# Usage: bash seismic_tpu_torch/harness/run_r5_queue.sh [stage ...]
#   stages default to: mem bench
#   c100k = rebuild_r3_cache 100k (dataset/index/GT/narrow dirs/knn16)
#   c1m   = rebuild_r3_cache 1m   (dataset/index/GT/narrow dir/knn16)
#   b88   = build_88m             (8.8M dataset + index, host only)
#   j     = probe_r3j 512         (8.8M rung -> chiprun_out/scale88_bench.json)
#   mem   = bench_mem --block     (lean memory rungs -> chiprun_out/mem_bench.json)
#   r5b   = probe_r5b             (100K headline levers -> chiprun_out/bench_stage_r5.json)
#   r5c   = probe_r5c             (1M bar rungs -> chiprun_out/scale_bench.json)
#   shard = bench_sharded --grouped (sharded rungs -> chiprun_out/sharded_bench.json)
#   bench = the headline benchmark: no port yet (it belongs to a benchmark
#           change); the stage is logged FAILED, never skipped silently
#   r5b_<family>, r5c_<family> = one family of the probe
# Environment: CACHE_DIR (the drivers' --cache-dir; default their own,
# .bench_cache/torch/), LOGDIR (default chiprun_out/r5queue), DEVICE (the
# drivers' --device, default the card), PYTHON (default python).
set -u
cd "$(dirname "$0")/../.."
LOGDIR=${LOGDIR:-chiprun_out/r5queue}
mkdir -p "$LOGDIR"
CARD_CHECK_S=${CARD_CHECK_S:-120}
CARD_CHECK_TRIES=${CARD_CHECK_TRIES:-3}
PYTHON=${PYTHON:-python}
# serialize queue instances (one card process at a time); a second
# invocation waits here until the first finishes
exec 9>"${TMPDIR:-/tmp}/seismic_tpu_torch_queue.lock"
flock 9

log() { echo "[queue $(date +%H:%M:%S)] $*" | tee -a "$LOGDIR/queue.log"; }

# The card check: a 16-thread kernel (PTX, JIT-compiled by the driver)
# writes 2 * i at word i on the card and the host reads the words back,
# through the driver API (ctypes, libcuda): no framework to import, about
# a second. With DEVICE=cpu the check passes without a card.
read -r -d '' CARD_CHECK_PY <<'PYEOF' || true
import ctypes, sys
if sys.argv[1:] == ["cpu"]:
    print("card check: DEVICE=cpu")
    sys.exit(0)
PTX = b"""
.version 7.0
.target sm_50
.address_size 64
.visible .entry twice(.param .u64 p)
{
  .reg .b32 %r<3>;
  .reg .b64 %rd<5>;
  ld.param.u64 %rd1, [p];
  cvta.to.global.u64 %rd2, %rd1;
  mov.u32 %r1, %tid.x;
  mul.wide.u32 %rd3, %r1, 4;
  add.s64 %rd4, %rd2, %rd3;
  shl.b32 %r2, %r1, 1;
  st.global.u32 [%rd4], %r2;
  ret;
}
"""
cu = ctypes.CDLL("libcuda.so.1")
vp, u32, u64 = ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint64


def ok(rc, what):
    if rc != 0:
        sys.exit(f"card check: {what} returned CUresult {rc}")


dev, ctx, mod, fn, buf = ctypes.c_int(), vp(), vp(), vp(), u64()
ok(cu.cuInit(0), "cuInit")
ok(cu.cuDeviceGet(ctypes.byref(dev), 0), "cuDeviceGet")
ok(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev), "context")
ok(cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
ok(cu.cuModuleLoadData(ctypes.byref(mod), ctypes.c_char_p(PTX + b"\0")),
   "cuModuleLoadData")
ok(cu.cuModuleGetFunction(ctypes.byref(fn), mod, b"twice"), "function")
ok(cu.cuMemAlloc_v2(ctypes.byref(buf), ctypes.c_size_t(64)), "cuMemAlloc")
arg = u64(buf.value)
params = (vp * 1)(ctypes.cast(ctypes.pointer(arg), vp))
cu.cuLaunchKernel.argtypes = [vp, u32, u32, u32, u32, u32, u32, u32, vp,
                              ctypes.POINTER(vp), vp]
ok(cu.cuLaunchKernel(fn, 1, 1, 1, 16, 1, 1, 0, None, params, None),
   "cuLaunchKernel")
ok(cu.cuCtxSynchronize(), "cuCtxSynchronize")
out = (ctypes.c_uint32 * 16)()
cu.cuMemcpyDtoH_v2.argtypes = [vp, u64, ctypes.c_size_t]
ok(cu.cuMemcpyDtoH_v2(ctypes.cast(out, vp), buf, 64), "cuMemcpyDtoH")
if list(out) != [2 * i for i in range(16)]:
    sys.exit(f"card check: the card computed {list(out)}")
print("card compute ok")
PYEOF

card_check() {
  # a computation on the card, round-tripped to the host, bounded in time
  # and tries
  local i
  for i in $(seq 1 "$CARD_CHECK_TRIES"); do
    if timeout "$CARD_CHECK_S" "$PYTHON" -c "$CARD_CHECK_PY" ${DEVICE:-} \
        >>"$LOGDIR/card_check.log" 2>&1; then
      return 0
    fi
    log "card check $i/$CARD_CHECK_TRIES failed (see $LOGDIR/card_check.log)"
    sleep 5
  done
  return 1
}

# run_stage NAME BOUND OPTS MODULE [ARG ...]: the port's module under a
# timeout of BOUND seconds, its output in $LOGDIR/NAME.log; OPTS names the
# queue settings it takes: c (--cache-dir $CACHE_DIR), d (--device $DEVICE)
run_stage() {
  local name=$1 bound=$2 opts=$3 mod=$4
  shift 4
  local cmd=("$PYTHON" -m "seismic_tpu_torch.harness.$mod" "$@")
  if [[ $opts == *c* && -n "${CACHE_DIR:-}" ]]; then
    cmd+=(--cache-dir "$CACHE_DIR")
  fi
  if [[ $opts == *d* && -n "${DEVICE:-}" ]]; then
    cmd+=(--device "$DEVICE")
  fi
  log "stage $name: START (${cmd[*]})"
  if timeout "$bound" "${cmd[@]}" >"$LOGDIR/$name.log" 2>&1; then
    log "stage $name: OK"
  else
    log "stage $name: FAILED rc=$? (see $LOGDIR/$name.log)"
  fi
}

STAGES=${*:-mem bench}
for s in $STAGES; do
  case $s in
    b88 | bench) ;;  # the host build; the stage with no port
    *)
      if ! card_check; then
        log "stage $s: FAILED (no CUDA computation made the round trip)"
        continue
      fi
      ;;
  esac
  case $s in
    c100k) run_stage c100k 20000 cd rebuild_r3_cache 100k ;;
    c1m)   run_stage c1m 20000   cd rebuild_r3_cache 1m ;;
    b88)   run_stage b88 28000   c build_88m --n-docs "${B88_N_DOCS:-8800000}" ;;
    j)     run_stage r3j 12000   cd probe_r3j 512 ;;
    mem)   run_stage mem 7200    d bench_mem --block --batch 4096 ;;
    r5b)   run_stage r5b 9000    cd probe_r5b ;;
    r5c)   run_stage r5c 10000   cd probe_r5c ;;
    r5b_grid2) run_stage r5b_grid2 5000 cd probe_r5b grid2 ;;
    r5b_knn)   run_stage r5b_knn   5000 cd probe_r5b knn ;;
    r5b_b1)    run_stage r5b_b1    5000 cd probe_r5b b1 ;;
    r5b_2pass) run_stage r5b_2pass 5000 cd probe_r5b 2pass ;;
    r5b_csub4) run_stage r5b_csub4 5000 cd probe_r5b csub4 ;;
    r5b_pdt)   run_stage r5b_pdt   5000 cd probe_r5b pdt ;;
    r5b_m32)   run_stage r5b_m32   5000 cd probe_r5b m32 ;;
    r5b_seg)   run_stage r5b_seg   5000 cd probe_r5b seg ;;
    r5c_lever) run_stage r5c_lever 6000 cd probe_r5c 1024 lever ;;
    r5c_deep)  run_stage r5c_deep  6000 cd probe_r5c 1024 deep ;;
    r5c_bar)   run_stage r5c_bar   6000 cd probe_r5c 1024 bar ;;
    r5c_b4k)   run_stage r5c_b4k   6000 cd probe_r5c 1024 b4k ;;
    r5c_lean16) (export R5C_FWD16=1; run_stage r5c_lean16 6000 cd probe_r5c 1024 lean16) ;;
    r5c_b4kf)  (export R5C_FWD16=1; run_stage r5c_b4kf 6000 cd probe_r5c 1024 b4kf) ;;
    shard) run_stage shard 7200  d bench_sharded --grouped ;;
    bench) log "stage bench: FAILED (the headline benchmark has no port yet: it belongs to a benchmark change)" ;;
    *)     log "stage $s: FAILED (unknown stage)" ;;
  esac
done
log "queue complete"
