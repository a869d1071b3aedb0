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
    models/       the motion, colour and phase (Riesz) pipelines as step
                  functions with explicit carried state, and the processing
                  chain around them
    parallel/     the mesh, the halo exchanges and the lane-sharded phase step
    export/       sequential clip processing with checkpoint/resume, the
                  export types and the pane composition
    io/           video file decode and encode (OpenCV, imported when called)
    convert.py    carried state and dynamic parameters from the JAX package
    cli.py        the ``info`` and ``magnify`` commands

Ported so far: all three modes through the chain, ClipProcessor and the
CLI's offline commands, and the lane-sharded phase step. The time-parallel
forms, the engine, the other commands and the rest of parallel/ are still to
come (ROADMAP.md).
"""

__version__ = "0.1.0"
