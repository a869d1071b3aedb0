"""PyTorch / CUDA port of the Eulerian video magnification framework.

The JAX package ``live_video_magnification_tpu`` is the frozen reference; this
package mirrors its module layout so each function has a counterpart of the
same name, and imports neither JAX nor anything of the reference package.

Layering (lower layers never import higher ones):

    device.py     device resolution (CUDA by default, CPU only when asked)
                  and the IEEE-f32 pin
    ops/          plain PyTorch ops with the reference's OpenCV semantics;
                  ops/hopper/ holds the hand-written CUDA kernels (sm_90a)
                  that carry the pyramid stencils on the card
    models/       the phase (Riesz) pipeline as a step function with explicit
                  carried state, and the processing chain around it
    parallel/     the mesh, the halo exchanges and the lane-sharded phase step
    export/       sequential clip processing with checkpoint/resume
    convert.py    carried state and dynamic parameters from the JAX package

Ported so far: the phase main path and its lane-sharded step. Motion and
color modes, the time-parallel forms, the engine, video I/O, the CLI and the
rest of parallel/ are still to come (ROADMAP.md).
"""

__version__ = "0.1.0"
