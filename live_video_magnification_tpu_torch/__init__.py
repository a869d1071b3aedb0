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
    parallel/     the mesh, the halo exchanges and the lane-sharded phase step;
                  the time mesh of the batch export and its multi-process
                  bring-up (``time_shard.py``, the boundary step between
                  time shards, imports only torch: models/ use it)
    export/       sequential clip processing with checkpoint/resume, the
                  export types, the pane composition, the recording buffer,
                  the export frame sources and the ``Exporter`` worker
    engine/       the host streaming runtime: sources, pool, Block/Drop
                  queue, the processing consumer, the mailbox,
                  instrumentation, the playback controller and the native
                  C++ transport's ctypes adapter
    io/           video file decode and encode (OpenCV, imported when called)
    convert.py    carried state and dynamic parameters from the JAX package
    gui.py        the desktop window (tkinter) and theme.py its palette
    cli.py        the ``info``, ``magnify``, ``live``, ``record``,
                  ``cameras`` and ``bench`` commands
    bench.py      the benchmarks (the reference's root ``bench.py``)

Every module of the reference package has its counterpart here: all three
modes through the chain, ClipProcessor and the CLI's offline commands
(sequential, ``--time-parallel`` and ``--distributed``), the lane- and
row-sharded steps, the time mesh, the live engine, the record-and-export
flow, the GUI, the GL present path and the benchmarks.
"""

__version__ = "0.1.0"
