"""mpv_frame_interpolator_tpu_torch -- the PyTorch + CUDA port of the
frame interpolator, for one NVIDIA Hopper card (sm_90a).

It sits beside the JAX package ``mpv_frame_interpolator_tpu``, which stays
the reference, and keeps that package's layout and names: each module here
is the counterpart of the module at the same path there.  It imports
nothing of that package: the host modules it needs are its own copies
(frame, models, the flow geometry of ops.oracle, io.synthetic, io.y4m,
pipeline.cadence, pipeline.quality, pipeline.present, utils, and those
named below).  The port covers every model family (hopper, hopperx,
hopperq, hopperxq, blend, repeat), scene detection, 8-bit NV12 and 10-bit
P010, any black/white levels, output modes 0-6 (warp12, warp21, blend,
hsv, grey, sbs1, sbs2) and every warp sampler of mode 2 ("pair", "shift"
and "gather" on K2, "fused" on K4, "pallas" on K5 and G1), search radii
2-256 with the degradation ladder and the measured sub-pel flow, and:

  pipeline/player.py   the player around the engine: a prefetch thread
                       with staged uploads from page-locked buffers, seek,
                       pause, frame-step, loop and end, counted fail-open;
                       the grouped encode path (engine.push_many, CUDA
                       graph replays)
  io/                  every source and sink of the CLI: y4m, Matroska,
                       AVI and MP4 with raw video, FFV1, Ut Video or
                       MJPEG, image sequences, stdin, streams, playlists
                       and EDL, the frame cache, backward play, host
                       filters; y4m, FFV1 Matroska, PGM/PNG dumps and the
                       OSD.  Its codecs and reader rings are the native
                       host library (native/*.cpp), built with g++ at
                       first use
  api.py               Player: the libmpv-style properties, commands and
                       events over the engine's runtime state
  control/             the settings applet's FIFO protocol and its
                       terminal client, key bindings and the terminal
                       reader, JSON IPC on a unix socket
  options.py           config files and profiles
  pipeline/resume.py   watch-later positions
  utils/trace.py       torch.profiler traces (the CLI's --profile-dir)

Its device work is hand-written CUDA kernels (``csrc/*.cu``), one for each
Pallas kernel of the JAX package plus G1, Q1 and S1, each with a plain
PyTorch twin that is both its specification and its CPU path:

  ops/cuda/flow_step.py    K1: the whole flow pyramid of a pair in one
                           cooperative launch, with the blur (K3's tile
                           body) as its last phase
  ops/cuda/blur.py         K3: the 8x8 box blur of the flow field on its
                           own (the public ops/flow.blur_flow)
  ops/cuda/warp_pair.py    K2: every blended output of one source pair
  ops/cuda/warp_fused.py   K4: the blended output of one blend position
  ops/cuda/warp_sample.py  K5: the raw samples of one direction at one
                           position (modes 0, 1, 3 and "pallas")
  ops/cuda/blend_levels.py G1: the blend and level maps of K5's two
                           directions, with hopperx's occlusion correction
                           as a variant (not a TPU kernel: XLA's fusion)
  ops/cuda/warp_bilinear.py Q1: one 1/64-pel bilinear blended position of
                           hopperq / hopperxq (not a TPU kernel: XLA's
                           shift sampler)
  ops/cuda/subpel.py       S1: the sub-pel refinement of the flow (not a
                           TPU kernel: XLA's subpel_refine)
  tools/pack_probe.py,     P1, P2: the toolchain probes
  tools/dma_probe.py

Importing the package touches neither ``torch.cuda`` nor any compiler: the
kernels are built with ``nvcc`` at their first launch (ops/cuda/_build.py),
the native host library with ``g++`` at its first use (native/).
"""

__version__ = "0.1.0"
