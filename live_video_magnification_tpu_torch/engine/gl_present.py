"""GL-class present path (reference ui/DisplayWidget.cpp re-designed on PyOpenGL).

The reference presents through a QOpenGLWidget: two persistent GPU textures
(processed / original) re-uploaded ONLY when the mailbox seq advances — one
seq check keeps both panes in lockstep (DisplayWidget.cpp:216-236); BGR bytes
are uploaded as RGB with a .bgr fragment swizzle, gray frames as a GL_R8
texture replicated across RGB (DisplayWidget.cpp:39-52); geometry changes
re-allocate the texture while same-size frames go through glTexSubImage2D
(DisplayWidget.cpp:133-158); each pane gets an aspect-fit letterbox viewport
(DisplayWidget.cpp:160-185); the four view modes place the panes
(DisplayWidget.cpp:187-210); sequence gaps are accounted as display skips
(DisplayWidget.cpp:229-234).

The counterpart of the reference package's ``engine/gl_present.py``. The
chain runs on the card (``PlaybackController(device=...)``), and the
mailbox holds host numpy frames, both panes read back by
``engine/processing.py::hwc_result``: the presenter uploads them exactly as
the reference package's does. ``OpenGL``, its ``EGL`` bindings and ``glfw``
are imported inside the calls that use them, so this module imports on a
machine with none of them (a GPU server often has no display and no GL
packages).

This module reproduces that present path with a real OpenGL pipeline behind
two context harnesses:

* ``HeadlessGLContext`` — EGL surfaceless (Mesa llvmpipe or a GPU driver)
  rendering into an FBO. No window system required: the test suite and the
  present benchmark EXECUTE the actual GL calls in this image, and
  ``read_pixels`` gives tests the composited framebuffer.
* ``WindowGLContext`` — a glfw window for a real desktop
  (``cli.py live --gl``); same ``GLPresenter``, swap instead of readback.

The data path stays the framework's: ``LatestFrameMailbox`` latest-wins pull
at ~120 Hz (``GLDisplayLoop``), no-new-frame polls doing no GL work beyond
the clear+redraw, exactly like the reference's paint timer.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

# PyOpenGL binds its window-system layer at import time; without a display
# the EGL entry points are the only ones that can produce a context.
if "PYOPENGL_PLATFORM" not in os.environ and not os.environ.get("DISPLAY"):
    os.environ["PYOPENGL_PLATFORM"] = "egl"

from live_video_magnification_tpu_torch.engine.display import ViewMode
from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
from live_video_magnification_tpu_torch.engine.mailbox import DisplayFrame, LatestFrameMailbox

_VERT_SRC = """#version 330 core
layout(location = 0) in vec2 pos;
layout(location = 1) in vec2 uv;
out vec2 v_uv;
void main() {
    v_uv = uv;
    gl_Position = vec4(pos, 0.0, 1.0);
}
"""

# BGR frames are uploaded as GL_RGB (no host-side channel shuffle), so the
# sample comes back (b, g, r) and the swizzle restores display RGB; gray
# frames are GL_R8 replicated here (DisplayWidget.cpp:39-52 semantics).
_FRAG_SRC = """#version 330 core
in vec2 v_uv;
out vec4 rgba;
uniform sampler2D frame_tex;
uniform int is_gray;
void main() {
    vec3 t = texture(frame_tex, v_uv).rgb;
    rgba = (is_gray == 1) ? vec4(vec3(t.r), 1.0) : vec4(t.b, t.g, t.r, 1.0);
}
"""

# Clip-space quad; v flipped so image row 0 lands at the top of the pane.
_QUAD = np.asarray(
    [
        [-1.0, -1.0, 0.0, 1.0],
        [+1.0, -1.0, 1.0, 1.0],
        [-1.0, +1.0, 0.0, 0.0],
        [+1.0, +1.0, 1.0, 0.0],
    ],
    np.float32,
)


def pane_layout(mode: ViewMode, w: int, h: int):
    """Pane rectangles in top-left window coordinates, as the reference lays
    them out (DisplayWidget.cpp:187-210): (x, y, w, h, is_original) tuples.
    ORIGINAL doubles as the magnification-off preview; split views put the
    original left / top."""
    if mode is ViewMode.PROCESSED:
        return [(0, 0, w, h, False)]
    if mode is ViewMode.ORIGINAL:
        return [(0, 0, w, h, True)]
    if mode is ViewMode.SIDE_BY_SIDE:
        half = w // 2
        return [(0, 0, half, h, True), (half, 0, w - half, h, False)]
    half = h // 2
    return [(0, 0, w, half, True), (0, half, w, h - half, False)]


def letterbox(tex_w: int, tex_h: int, vx: int, vy: int, vw: int, vh: int):
    """Aspect-fit viewport inside a pane region, centered
    (DisplayWidget.cpp:163-173): returns (x, y, w, h) or None when either
    extent is empty."""
    if tex_w <= 0 or tex_h <= 0 or vw <= 0 or vh <= 0:
        return None
    frame_ar = tex_w / tex_h
    region_ar = vw / vh
    if region_ar > frame_ar:
        w, h = int(vh * frame_ar), vh
    else:
        w, h = vw, int(vw / frame_ar)
    return (vx + (vw - w) // 2, vy + (vh - h) // 2, w, h)


class _Tex:
    __slots__ = ("tex_id", "w", "h", "channels")

    def __init__(self, tex_id: int):
        self.tex_id = tex_id
        self.w = 0
        self.h = 0
        self.channels = 0


class GLPresenter:
    """The paint path: persistent textures + upload-on-new-seq + letterboxed
    pane draws. Requires a current GL context at construction and at every
    ``paint`` (the reference holds the same single-thread contract,
    DisplayWidget.hpp:27)."""

    def __init__(self, instr: Optional[Instrumentation] = None,
                 view_mode: ViewMode = ViewMode.PROCESSED):
        from OpenGL import GL

        self._gl = GL
        self.view_mode = view_mode
        self._instr = instr
        self._last_seq: Optional[int] = None
        self.uploads = 0        # glTexSubImage2D/glTexImage2D calls (tests)
        self.reallocs = 0       # geometry-change glTexImage2D calls (tests)

        self._program = self._build_program()
        self._u_tex = GL.glGetUniformLocation(self._program, "frame_tex")
        self._u_gray = GL.glGetUniformLocation(self._program, "is_gray")

        self._vao = GL.glGenVertexArrays(1)
        GL.glBindVertexArray(self._vao)
        self._vbo = GL.glGenBuffers(1)
        GL.glBindBuffer(GL.GL_ARRAY_BUFFER, self._vbo)
        GL.glBufferData(GL.GL_ARRAY_BUFFER, _QUAD.nbytes, _QUAD,
                        GL.GL_STATIC_DRAW)
        GL.glEnableVertexAttribArray(0)
        GL.glVertexAttribPointer(0, 2, GL.GL_FLOAT, GL.GL_FALSE, 16,
                                 ctypes.c_void_p(0))
        GL.glEnableVertexAttribArray(1)
        GL.glVertexAttribPointer(1, 2, GL.GL_FLOAT, GL.GL_FALSE, 16,
                                 ctypes.c_void_p(8))
        GL.glBindVertexArray(0)

        ids = GL.glGenTextures(2)
        self._tex_proc = _Tex(int(ids[0]))
        self._tex_orig = _Tex(int(ids[1]))
        for t in (self._tex_proc, self._tex_orig):
            GL.glBindTexture(GL.GL_TEXTURE_2D, t.tex_id)
            for pname, val in (
                (GL.GL_TEXTURE_MIN_FILTER, GL.GL_LINEAR),
                (GL.GL_TEXTURE_MAG_FILTER, GL.GL_LINEAR),
                (GL.GL_TEXTURE_WRAP_S, GL.GL_CLAMP_TO_EDGE),
                (GL.GL_TEXTURE_WRAP_T, GL.GL_CLAMP_TO_EDGE),
            ):
                GL.glTexParameteri(GL.GL_TEXTURE_2D, pname, val)
        GL.glBindTexture(GL.GL_TEXTURE_2D, 0)
        GL.glClearColor(0.0, 0.0, 0.0, 1.0)

    def _build_program(self) -> int:
        GL = self._gl

        def compile_shader(kind, src):
            sh = GL.glCreateShader(kind)
            GL.glShaderSource(sh, src)
            GL.glCompileShader(sh)
            if not GL.glGetShaderiv(sh, GL.GL_COMPILE_STATUS):
                raise RuntimeError(GL.glGetShaderInfoLog(sh).decode())
            return sh

        vs = compile_shader(GL.GL_VERTEX_SHADER, _VERT_SRC)
        fs = compile_shader(GL.GL_FRAGMENT_SHADER, _FRAG_SRC)
        prog = GL.glCreateProgram()
        GL.glAttachShader(prog, vs)
        GL.glAttachShader(prog, fs)
        GL.glLinkProgram(prog)
        if not GL.glGetProgramiv(prog, GL.GL_LINK_STATUS):
            raise RuntimeError(GL.glGetProgramInfoLog(prog).decode())
        GL.glDeleteShader(vs)
        GL.glDeleteShader(fs)
        return prog

    # -- upload ----------------------------------------------------------

    def _upload(self, img: np.ndarray, tex: _Tex) -> None:
        """(Re)upload one frame: GL_R8 for gray, GL_RGB8 for BGR-as-RGB;
        geometry change → glTexImage2D re-alloc, else glTexSubImage2D
        (DisplayWidget.cpp:133-158).

        Row-padded / non-contiguous views (pooled-arena slots, ROI crops)
        are densified here. The reference hands GL the raw padded cv::Mat
        pointer and declares the stride via GL_UNPACK_ROW_LENGTH
        (DisplayWidget.cpp:141-143); PyOpenGL copies a non-C-contiguous
        ndarray to a DENSE buffer before the call, so a stride-derived
        ROW_LENGTH would describe memory GL never sees (rows shift, the
        tail reads past the copy). Densify explicitly and keep the default
        tight unpack instead."""
        GL = self._gl
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        ch = 1 if img.ndim == 2 else int(img.shape[2])
        h, w = int(img.shape[0]), int(img.shape[1])
        img = np.ascontiguousarray(img)
        internal = GL.GL_R8 if ch == 1 else GL.GL_RGB8
        fmt = GL.GL_RED if ch == 1 else GL.GL_RGB

        GL.glBindTexture(GL.GL_TEXTURE_2D, tex.tex_id)
        GL.glPixelStorei(GL.GL_UNPACK_ALIGNMENT, 1)
        if (w, h, ch) != (tex.w, tex.h, tex.channels):
            GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, internal, w, h, 0, fmt,
                            GL.GL_UNSIGNED_BYTE, img)
            tex.w, tex.h, tex.channels = w, h, ch
            self.reallocs += 1
        else:
            GL.glTexSubImage2D(GL.GL_TEXTURE_2D, 0, 0, 0, w, h, fmt,
                               GL.GL_UNSIGNED_BYTE, img)
        self.uploads += 1
        GL.glBindTexture(GL.GL_TEXTURE_2D, 0)

    # -- draw ------------------------------------------------------------

    def _draw(self, tex: _Tex, vx: int, vy: int, vw: int, vh: int) -> None:
        GL = self._gl
        vp = letterbox(tex.w, tex.h, vx, vy, vw, vh)
        if vp is None:
            return
        GL.glViewport(*vp)
        GL.glUseProgram(self._program)
        GL.glBindVertexArray(self._vao)
        GL.glActiveTexture(GL.GL_TEXTURE0)
        GL.glBindTexture(GL.GL_TEXTURE_2D, tex.tex_id)
        GL.glUniform1i(self._u_tex, 0)
        GL.glUniform1i(self._u_gray, 1 if tex.channels == 1 else 0)
        GL.glDrawArrays(GL.GL_TRIANGLE_STRIP, 0, 4)
        GL.glBindTexture(GL.GL_TEXTURE_2D, 0)
        GL.glBindVertexArray(0)
        GL.glUseProgram(0)

    def paint(self, pair: Optional[DisplayFrame], fb_w: int, fb_h: int) -> bool:
        """One paintGL: upload (only) on a new seq, then draw every pane.
        Returns True when a new frame was consumed. The seq check covers
        both panes at once; gaps count as display skips
        (DisplayWidget.cpp:212-236)."""
        GL = self._gl
        GL.glViewport(0, 0, fb_w, fb_h)
        GL.glClear(GL.GL_COLOR_BUFFER_BIT)

        fresh = False
        if pair is not None and pair.processed is not None:
            seq = pair.processed.seq
            # monotonic like DisplayLoop.poll_once (display.py): a stale
            # lower-seq pair racing a restart's mailbox.clear() is ignored,
            # where the reference's plain `!=` would re-present it
            # (DisplayWidget.cpp:221) — both renderers must account
            # identically into the shared Instrumentation
            if self._last_seq is None or seq > self._last_seq:
                need_proc = self.view_mode is not ViewMode.ORIGINAL
                need_orig = self.view_mode is not ViewMode.PROCESSED
                if need_proc:
                    self._upload(pair.processed.data, self._tex_proc)
                if need_orig and pair.original is not None:
                    self._upload(pair.original.data, self._tex_orig)
                if self._instr is not None:
                    skipped = (
                        0 if self._last_seq is None
                        else max(0, seq - self._last_seq - 1)
                    )
                    self._instr.on_displayed(skipped=skipped)
                self._last_seq = seq
                fresh = True

        for (x, y, w, h, is_orig) in pane_layout(self.view_mode, fb_w, fb_h):
            tex = self._tex_orig if is_orig else self._tex_proc
            if tex.w <= 0:
                continue
            self._draw(tex, x, fb_h - (y + h), w, h)  # GL y-up flip
        return fresh

    def destroy(self) -> None:
        GL = self._gl
        GL.glDeleteTextures(
            2, np.asarray([self._tex_proc.tex_id, self._tex_orig.tex_id],
                          np.uint32))
        GL.glDeleteBuffers(1, np.asarray([self._vbo], np.uint32))
        GL.glDeleteVertexArrays(1, np.asarray([self._vao], np.uint32))
        GL.glDeleteProgram(self._program)


class HeadlessGLContext:
    """EGL surfaceless context + FBO: the windowless harness that lets the
    test suite and the present benchmark execute the real GL path (Mesa
    llvmpipe in this image; any EGL driver elsewhere)."""

    _SURFACELESS_MESA = 0x31DD  # EGL_PLATFORM_SURFACELESS_MESA

    def __init__(self, width: int, height: int):
        from OpenGL import EGL, GL

        self._egl, self._gl = EGL, GL
        self.width, self.height = int(width), int(height)

        dpy = EGL.eglGetPlatformDisplayEXT(
            self._SURFACELESS_MESA, EGL.EGL_DEFAULT_DISPLAY, None)
        major, minor = EGL.EGLint(), EGL.EGLint()
        if not EGL.eglInitialize(dpy, major, minor):
            raise RuntimeError("eglInitialize failed (no surfaceless EGL)")
        self._dpy = dpy

        cfg_attrs = (EGL.EGLint * 5)(
            EGL.EGL_SURFACE_TYPE, EGL.EGL_PBUFFER_BIT,
            EGL.EGL_RENDERABLE_TYPE, EGL.EGL_OPENGL_BIT, EGL.EGL_NONE)
        cfgs = (EGL.EGLConfig * 1)()
        n = EGL.EGLint()
        if not EGL.eglChooseConfig(dpy, cfg_attrs, cfgs, 1, n) or n.value < 1:
            raise RuntimeError("no EGL config with desktop-GL support")
        EGL.eglBindAPI(EGL.EGL_OPENGL_API)
        self._ctx = EGL.eglCreateContext(dpy, cfgs[0], EGL.EGL_NO_CONTEXT,
                                         None)
        if not self._ctx:
            raise RuntimeError("eglCreateContext failed")
        self.make_current()

        self._fbo = GL.glGenFramebuffers(1)
        self._rbo = GL.glGenRenderbuffers(1)
        GL.glBindRenderbuffer(GL.GL_RENDERBUFFER, self._rbo)
        GL.glRenderbufferStorage(GL.GL_RENDERBUFFER, GL.GL_RGB8,
                                 self.width, self.height)
        GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, self._fbo)
        GL.glFramebufferRenderbuffer(
            GL.GL_FRAMEBUFFER, GL.GL_COLOR_ATTACHMENT0, GL.GL_RENDERBUFFER,
            self._rbo)
        status = GL.glCheckFramebufferStatus(GL.GL_FRAMEBUFFER)
        if status != GL.GL_FRAMEBUFFER_COMPLETE:
            raise RuntimeError(f"FBO incomplete: 0x{int(status):x}")

    def make_current(self) -> None:
        EGL = self._egl
        EGL.eglBindAPI(EGL.EGL_OPENGL_API)  # per-THREAD state in EGL
        if not EGL.eglMakeCurrent(self._dpy, EGL.EGL_NO_SURFACE,
                                  EGL.EGL_NO_SURFACE, self._ctx):
            raise RuntimeError("eglMakeCurrent failed")

    def release_current(self) -> None:
        """Unbind from the calling thread (an EGL context can be current in
        only one thread — release before handing it to GLDisplayLoop)."""
        EGL = self._egl
        EGL.eglMakeCurrent(self._dpy, EGL.EGL_NO_SURFACE, EGL.EGL_NO_SURFACE,
                           EGL.EGL_NO_CONTEXT)

    def swap(self) -> None:
        """Headless 'swap': a glFinish, so present timing includes the full
        raster (the windowed path swaps buffers here)."""
        self._gl.glFinish()

    def read_pixels(self) -> np.ndarray:
        """Framebuffer contents as (h, w, 3) u8, row 0 = top (flipped from
        GL's bottom-up readout) — the test oracle's view of the screen."""
        GL = self._gl
        GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, self._fbo)
        GL.glPixelStorei(GL.GL_PACK_ALIGNMENT, 1)
        raw = GL.glReadPixels(0, 0, self.width, self.height, GL.GL_RGB,
                              GL.GL_UNSIGNED_BYTE)
        img = np.frombuffer(raw, np.uint8).reshape(self.height, self.width, 3)
        return img[::-1]

    def destroy(self) -> None:
        GL, EGL = self._gl, self._egl
        GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, 0)
        GL.glDeleteFramebuffers(1, np.asarray([self._fbo], np.uint32))
        GL.glDeleteRenderbuffers(1, np.asarray([self._rbo], np.uint32))
        EGL.eglMakeCurrent(self._dpy, EGL.EGL_NO_SURFACE, EGL.EGL_NO_SURFACE,
                           EGL.EGL_NO_CONTEXT)
        EGL.eglDestroyContext(self._dpy, self._ctx)
        EGL.eglTerminate(self._dpy)


class WindowGLContext:
    """glfw-windowed context for a real desktop (`cli.py live --gl`). Same
    GLPresenter; swap presents to the screen (vsync caps the rate, like the
    reference's QOpenGLWidget)."""

    def __init__(self, width: int, height: int, title: str = "lvmt"):
        import glfw

        self._glfw = glfw
        if not glfw.init():
            raise RuntimeError("glfw.init failed (no display?)")
        glfw.window_hint(glfw.CONTEXT_VERSION_MAJOR, 3)
        glfw.window_hint(glfw.CONTEXT_VERSION_MINOR, 3)
        glfw.window_hint(glfw.OPENGL_PROFILE, glfw.OPENGL_CORE_PROFILE)
        self._win = glfw.create_window(width, height, title, None, None)
        if not self._win:
            glfw.terminate()
            raise RuntimeError("glfw.create_window failed")
        self.make_current()
        glfw.swap_interval(1)  # vsync paces the present loop (~QOpenGLWidget)

    @property
    def width(self) -> int:
        return self._glfw.get_framebuffer_size(self._win)[0]

    @property
    def height(self) -> int:
        return self._glfw.get_framebuffer_size(self._win)[1]

    def make_current(self) -> None:
        self._glfw.make_context_current(self._win)

    def swap(self) -> None:
        self._glfw.swap_buffers(self._win)
        self._glfw.poll_events()

    def should_close(self) -> bool:
        return bool(self._glfw.window_should_close(self._win))

    def destroy(self) -> None:
        self._glfw.destroy_window(self._win)
        self._glfw.terminate()


class GLDisplayLoop:
    """The ~120 Hz present timer around GLPresenter: polls the mailbox,
    paints, swaps — the reference's presentTimer_ + paintGL loop
    (DisplayWidget.cpp:59-62,212-236) on a dedicated thread that owns the
    context."""

    def __init__(self, mailbox: LatestFrameMailbox, instr: Instrumentation,
                 ctx, poll_hz: float = 120.0,
                 view_mode: ViewMode = ViewMode.PROCESSED):
        self._mailbox = mailbox
        self._instr = instr
        self._ctx = ctx
        self._interval = 1.0 / poll_hz
        self._view_mode = view_mode
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="GLDisplayLoop")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        self._ctx.make_current()
        presenter = None
        try:
            presenter = GLPresenter(self._instr, self._view_mode)
            while not self._stop.wait(self._interval):
                if getattr(self._ctx, "should_close", lambda: False)():
                    break
                presenter.paint(self._mailbox.latest(),
                                self._ctx.width, self._ctx.height)
                self._ctx.swap()
        finally:
            if presenter is not None:
                presenter.destroy()
            # a context left current in an exited thread stays unusable
            # everywhere — unbind before the thread dies (also on a failed
            # presenter construction, e.g. a shader compile error)
            release = getattr(self._ctx, "release_current", None)
            if release is not None:
                release()


def gl_available() -> bool:
    """True when a GL context (headless EGL or windowed) can be created."""
    try:
        ctx = HeadlessGLContext(8, 8)
        ctx.destroy()
        return True
    except Exception:
        return False
