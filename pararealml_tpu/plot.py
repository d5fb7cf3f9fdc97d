"""Matplotlib visualization of solutions.

Covers the same plot families as the reference's visualization layer
(/root/reference/pararealml/plot.py): time series and phase-space
trajectories for ODE systems, animated n-body scatter views, and
line/contour/surface/scatter/stream/quiver renderings of 1D/2D/3D PDE
fields, all aware of curvilinear meshes through the mesh's Cartesian
coordinate grids and unit-vector fields. The implementation is a fresh
design: animated plots are template-method subclasses that render
frames through overridden methods rather than injected closures, and
input validation is centralized in module-level guards.

Everything in this module is host-side; solver code never imports it,
and matplotlib is imported only when a plot is built.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple, Union

import numpy as np

from pararealml_tpu.differential_equation import NBodyGravitationalEquation
from pararealml_tpu.mesh import CoordinateSystem, Mesh

if TYPE_CHECKING:
    from matplotlib.colors import Colormap
    from matplotlib.figure import Figure


def _pyplot():
    """Imports pyplot on first use, so that importing this module (and
    the package root) does not need matplotlib."""
    import matplotlib.pyplot as plt

    return plt


def _colormap(color_map: Union[str, "Colormap"]) -> "Colormap":
    import matplotlib

    if isinstance(color_map, str):
        return matplotlib.colormaps[color_map]
    return color_map


def _require_trajectory_rank(y: np.ndarray, rank: int):
    if y.ndim != rank:
        message = (
            f"trajectory array must have {rank} axes, got {y.ndim}"
        )
        raise ValueError(message)


def _require_field(
    y: np.ndarray,
    mesh: Mesh,
    vertex_oriented: bool,
    spatial_dimensions: Union[int, Tuple[int, int]],
    components: Optional[int],
):
    """Validates a ``(time, *grid, components)`` PDE field array against
    the mesh it is plotted over.

    ``spatial_dimensions`` is the supported mesh dimensionality (or an
    inclusive range); ``components`` is the required number of trailing
    field components (``None`` means one per mesh dimension, i.e. a
    vector field)."""
    if isinstance(spatial_dimensions, int):
        lo = hi = spatial_dimensions
    else:
        lo, hi = spatial_dimensions
    if not lo <= mesh.dimensions <= hi:
        supported = str(lo) if lo == hi else f"{lo} to {hi}"
        message = (
            f"this plot supports {supported}-dimensional meshes, got "
            f"{mesh.dimensions}"
        )
        raise ValueError(message)
    grid_shape = mesh.shape(vertex_oriented)
    expected_rank = len(grid_shape) + 2
    if y.ndim != expected_rank:
        message = (
            f"field array must have {expected_rank} axes "
            f"(time, {len(grid_shape)} spatial, components), got {y.ndim}"
        )
        raise ValueError(message)
    if tuple(y.shape[1:-1]) != tuple(grid_shape):
        message = (
            f"field spatial extents {y.shape[1:-1]} do not match the "
            f"mesh grid {tuple(grid_shape)}"
        )
        raise ValueError(message)
    required = mesh.dimensions if components is None else components
    if y.shape[-1] != required:
        message = (
            f"field must have {required} component(s) per point, got "
            f"{y.shape[-1]}"
        )
        raise ValueError(message)


def _value_range(
    y: np.ndarray, v_min: Optional[float], v_max: Optional[float]
) -> Tuple[float, float]:
    """The color/axis value range, defaulting to the field's extrema."""
    return (
        float(np.min(y)) if v_min is None else v_min,
        float(np.max(y)) if v_max is None else v_max,
    )


class Plot:
    """A static plot backed by a matplotlib figure."""

    _default_save_extension = "png"

    def __init__(self, figure: Figure):
        self._figure = figure

    def show(self) -> "Plot":
        """Renders the figure in the active matplotlib backend."""
        _pyplot().show()
        return self

    def save(
        self, file_path: str,
        extension: Optional[str] = None,
        **kwargs,
    ) -> "Plot":
        """Writes the plot to ``file_path.extension`` (PNG for static
        plots, GIF for animations, unless overridden)."""
        extension = extension or self._default_save_extension
        self._write(f"{file_path}.{extension}", **kwargs)
        return self

    def close(self):
        """Releases the figure's resources."""
        _pyplot().close(self._figure)

    def _write(self, full_path: str, **kwargs):
        self._figure.savefig(full_path, **kwargs)


class AnimatedPlot(Plot):
    """A plot animated over the trajectory's time axis.

    Subclasses assign ``self._figure`` data and implement
    :meth:`_render_initial` and :meth:`_render_frame`; the base class
    schedules ``n_frames`` evenly spaced time steps and drives the
    matplotlib animation through those hooks."""

    _default_save_extension = "gif"

    def __init__(
        self, figure: Figure,
        n_time_steps: int,
        n_frames: int,
        interval: int,
    ):
        super().__init__(figure)
        schedule = np.unique(
            np.round(
                np.linspace(0, n_time_steps - 1, max(int(n_frames), 1))
            ).astype(int)
        ) if n_frames < n_time_steps else np.arange(n_time_steps)
        from matplotlib.animation import FuncAnimation

        self._animation = FuncAnimation(
            figure,
            func=self._render_frame,
            init_func=self._render_initial,
            frames=schedule,
            interval=interval,
        )

    def _render_initial(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def _render_frame(self, time_step: int):  # pragma: no cover
        raise NotImplementedError

    def _write(self, full_path: str, **kwargs):
        self._animation.save(full_path, **kwargs)


class TimePlot(Plot):
    """Line plot of each solution component against time (ODEs)."""

    def __init__(
        self, y: np.ndarray,
        t: np.ndarray,
        legend_location: Optional[str] = None,
        **_,
    ):
        _require_trajectory_rank(y, 2)
        if t.ndim != 1:
            message = (
                f"time coordinates must be a 1D array, got {t.ndim} axes"
            )
            raise ValueError(message)
        if len(t) != y.shape[0]:
            message = (
                f"trajectory length ({y.shape[0]}) and time coordinate "
                f"count ({len(t)}) disagree"
            )
            raise ValueError(message)

        figure, axes = _pyplot().subplots()
        for index, component in enumerate(y.T):
            axes.plot(t, component, label=f"y{index}")
        axes.set_xlabel("t")
        axes.set_ylabel("y")
        if legend_location is not None:
            axes.legend(loc=legend_location)
        figure.tight_layout()
        super().__init__(figure)


class PhaseSpacePlot(Plot):
    """Trajectory of a 2- or 3-component ODE system in its phase
    space."""

    def __init__(self, y: np.ndarray, **_):
        _require_trajectory_rank(y, 2)
        components = y.shape[1]
        if components not in (2, 3):
            message = (
                "phase-space plots need a 2- or 3-component system, got "
                f"{components} components"
            )
            raise ValueError(message)

        figure = _pyplot().figure()
        if components == 2:
            axes = figure.add_subplot()
            axes.plot(y[:, 0], y[:, 1])
            axes.axis("equal")
        else:
            axes = figure.add_subplot(projection="3d")
            axes.plot3D(y[:, 0], y[:, 1], y[:, 2])
            axes.set_zlabel("y2")
            axes.set_box_aspect(tuple(np.ptp(y, axis=0)))
        axes.set_xlabel("y0")
        axes.set_ylabel("y1")
        super().__init__(figure)


class NBodyPlot(AnimatedPlot):
    """Animated view of a gravitational n-body simulation: one marker
    per body (area scaled with mass) with optional orbit trails, on a
    dark background."""

    def __init__(
        self, y: np.ndarray,
        diff_eq: NBodyGravitationalEquation,
        n_frames: int = 100, interval: int = 100,
        color_map: Union[str, Colormap] = "cividis",
        smallest_marker_size: float = 10.0,
        draw_trajectory: bool = True,
        trajectory_line_style: str = ":",
        trajectory_line_width: float = 0.5,
        span_scaling_factor: float = 0.25,
        **_,
    ):
        _require_trajectory_rank(y, 2)
        if y.shape[1] != diff_eq.y_dimension:
            message = (
                f"trajectory has {y.shape[1]} state components but the "
                f"equation defines {diff_eq.y_dimension}"
            )
            raise ValueError(message)

        spatial = diff_eq.spatial_dimension
        n_bodies = diff_eq.n_objects
        position_count = n_bodies * spatial
        # positions[d] holds body coordinates along axis d over time
        self._positions = [
            y[:, axis:position_count:spatial] for axis in range(spatial)
        ]
        self._axis_limits = []
        for coordinates in self._positions:
            low, high = float(coordinates.min()), float(coordinates.max())
            margin = span_scaling_factor * (high - low)
            self._axis_limits.append((low - margin, high + margin))

        masses = np.asarray(diff_eq.masses, dtype=float)
        # marker area proportional to the cross-section of a sphere
        # whose volume is proportional to the body's mass
        volumes = masses * (smallest_marker_size / masses.min())
        self._marker_areas = np.pi * np.cbrt(
            3.0 * volumes / (4.0 * np.pi)
        ) ** 2
        self._colors = _colormap(color_map)(
            np.linspace(0.0, 1.0, n_bodies)
        )
        self._spatial = spatial
        self._draw_trails = draw_trajectory
        self._trail_style = trajectory_line_style
        self._trail_width = trajectory_line_width
        self._bodies = None
        self._trails: Optional[List] = None
        self._style = "dark_background"

        with _pyplot().style.context(self._style):
            figure = _pyplot().figure()
            self._axes = figure.add_subplot(
                projection="3d" if spatial == 3 else None
            )

        super().__init__(figure, y.shape[0], n_frames, interval)

    def _render_initial(self):
        axes = self._axes
        with _pyplot().style.context(self._style):
            axes.clear()
            start = [p[0, :] for p in self._positions]
            marker_kwargs = dict(s=self._marker_areas, c=self._colors)
            if self._spatial == 3:
                marker_kwargs["depthshade"] = False
            self._bodies = axes.scatter(*start, **marker_kwargs)

            if self._draw_trails:
                self._trails = [
                    axes.plot(
                        *[p[:1, body] for p in self._positions],
                        color=self._colors[body],
                        linestyle=self._trail_style,
                        linewidth=self._trail_width,
                    )[0]
                    for body in range(len(self._colors))
                ]

            axes.set_xlabel("x")
            axes.set_ylabel("y")
            axes.set_xlim(*self._axis_limits[0])
            axes.set_ylim(*self._axis_limits[1])
            if self._spatial == 2:
                axes.axis("scaled")
            else:
                axes.set_zlabel("z")
                axes.set_zlim(*self._axis_limits[2])
                axes.set_box_aspect(
                    tuple(high - low for low, high in self._axis_limits)
                )
                axes.set_facecolor("black")
                for spatial_axis in (axes.xaxis, axes.yaxis, axes.zaxis):
                    spatial_axis.pane.fill = False
                axes.grid(False)

    def _render_frame(self, time_step: int):
        if self._spatial == 2:
            self._bodies.set_offsets(
                np.stack(
                    [p[time_step, :] for p in self._positions], axis=-1
                )
            )
        else:
            self._bodies._offsets3d = tuple(
                p[time_step, :] for p in self._positions
            )
        if self._draw_trails:
            history = slice(0, time_step + 1)
            for body, trail in enumerate(self._trails):
                trail.set_xdata(self._positions[0][history, body])
                trail.set_ydata(self._positions[1][history, body])
                if self._spatial == 3:
                    trail.set_3d_properties(
                        self._positions[2][history, body]
                    )


class SpaceLinePlot(AnimatedPlot):
    """Animated profile of a 1D PDE scalar field."""

    def __init__(
        self, y: np.ndarray,
        mesh: Mesh, vertex_oriented: bool,
        n_frames: int = 100, interval: int = 100,
        v_min: Optional[float] = None, v_max: Optional[float] = None,
        equal_scale: bool = False,
        **_,
    ):
        _require_field(y, mesh, vertex_oriented, 1, 1)
        self._field = y
        self._x = mesh.coordinate_grids(vertex_oriented)[0]
        self._y_limits = _value_range(y, v_min, v_max)
        self._equal_scale = equal_scale
        self._profile = None
        figure, self._axes = _pyplot().subplots()
        super().__init__(figure, y.shape[0], n_frames, interval)

    def _render_initial(self):
        axes = self._axes
        axes.clear()
        (self._profile,) = axes.plot(self._x, self._field[0, :, 0])
        axes.set_ylim(*self._y_limits)
        axes.set_xlabel("x")
        axes.set_ylabel("y")
        if self._equal_scale:
            axes.axis("equal")

    def _render_frame(self, time_step: int):
        self._profile.set_ydata(self._field[time_step, :, 0])


class ContourPlot(AnimatedPlot):
    """Animated filled contours of a 2D PDE scalar field."""

    def __init__(
        self, y: np.ndarray,
        mesh: Mesh, vertex_oriented: bool,
        n_frames: int = 100, interval: int = 100,
        color_map: Union[str, Colormap] = "viridis",
        v_min: Optional[float] = None, v_max: Optional[float] = None,
        **_,
    ):
        _require_field(y, mesh, vertex_oriented, 2, 1)
        self._field = y
        self._grids = mesh.cartesian_coordinate_grids(vertex_oriented)
        self._limits = _value_range(y, v_min, v_max)
        self._color_map = color_map
        self._contours = None
        self._axes = None
        figure = _pyplot().figure()
        super().__init__(figure, y.shape[0], n_frames, interval)

    def _fill(self, time_step: int):
        return self._axes.contourf(
            *self._grids,
            self._field[time_step, ..., 0],
            vmin=self._limits[0],
            vmax=self._limits[1],
            cmap=self._color_map,
        )

    def _render_initial(self):
        self._figure.clear()
        self._axes = self._figure.add_subplot()
        self._contours = self._fill(0)
        self._axes.set_xlabel("x0")
        self._axes.set_ylabel("x1")
        self._axes.axis("scaled")
        from matplotlib.cm import ScalarMappable

        colors = ScalarMappable(cmap=self._color_map)
        colors.set_clim(*self._limits)
        self._figure.colorbar(mappable=colors, ax=self._axes)

    def _render_frame(self, time_step: int):
        self._contours.remove()
        self._contours = self._fill(time_step)


class SurfacePlot(AnimatedPlot):
    """Animated 3D surface of a 2D PDE scalar field."""

    def __init__(
        self, y: np.ndarray,
        mesh: Mesh, vertex_oriented: bool,
        n_frames: int = 100, interval: int = 100,
        color_map: Union[str, Colormap] = "viridis",
        v_min: Optional[float] = None, v_max: Optional[float] = None,
        equal_scale: bool = False,
        **_,
    ):
        _require_field(y, mesh, vertex_oriented, 2, 1)
        self._field = y
        self._grids = mesh.cartesian_coordinate_grids(vertex_oriented)
        self._limits = _value_range(y, v_min, v_max)

        spans = (np.ptp(self._grids[0]), np.ptp(self._grids[1]))
        height_span = (
            self._limits[1] - self._limits[0]
            if equal_scale
            else min(spans)
        )
        self._box_aspect = (*spans, height_span)
        self._surface_kwargs = dict(
            vmin=self._limits[0],
            vmax=self._limits[1],
            rstride=1,
            cstride=1,
            linewidth=0,
            antialiased=False,
            cmap=color_map,
        )
        self._surface = None
        figure = _pyplot().figure()
        self._axes = figure.add_subplot(projection="3d")
        super().__init__(figure, y.shape[0], n_frames, interval)

    def _render_initial(self):
        axes = self._axes
        axes.clear()
        self._surface = axes.plot_surface(
            *self._grids, self._field[0, ..., 0], **self._surface_kwargs
        )
        axes.set_xlabel("x0")
        axes.set_ylabel("x1")
        axes.set_zlabel("y")
        axes.set_zlim(*self._limits)
        axes.set_box_aspect(self._box_aspect)

    def _render_frame(self, time_step: int):
        self._surface.remove()
        self._surface = self._axes.plot_surface(
            *self._grids,
            self._field[time_step, ..., 0],
            **self._surface_kwargs,
        )


class ScatterPlot(AnimatedPlot):
    """Animated scatter rendering of a 3D PDE scalar field, with the
    field value encoded as marker color."""

    def __init__(
        self, y: np.ndarray,
        mesh: Mesh, vertex_oriented: bool,
        n_frames: int = 100, interval: int = 100,
        color_map: Union[str, Colormap] = "viridis",
        v_min: Optional[float] = None, v_max: Optional[float] = None,
        marker_shape: str = "o",
        marker_size: Union[float, np.ndarray] = 20.0,
        marker_opacity: float = 1.0,
        **_,
    ):
        _require_field(y, mesh, vertex_oriented, 3, 1)
        self._field = y
        self._grids = mesh.cartesian_coordinate_grids(vertex_oriented)
        from matplotlib.cm import ScalarMappable

        self._colors = ScalarMappable(cmap=color_map)
        self._colors.set_clim(*_value_range(y, v_min, v_max))
        self._marker_shape = marker_shape
        self._marker_size = marker_size
        self._marker_opacity = marker_opacity
        self._markers = None
        figure = _pyplot().figure()
        self._axes = figure.add_subplot(projection="3d")
        super().__init__(figure, y.shape[0], n_frames, interval)

    def _render_initial(self):
        axes = self._axes
        axes.clear()
        axes.set_xlabel("x0")
        axes.set_ylabel("x1")
        axes.set_zlabel("x2")
        axes.set_box_aspect(tuple(np.ptp(g) for g in self._grids))
        self._markers = axes.scatter(
            *self._grids,
            c=self._colors.to_rgba(self._field[0, ..., 0].ravel()),
            marker=self._marker_shape,
            s=self._marker_size,
            alpha=self._marker_opacity,
        )

    def _render_frame(self, time_step: int):
        self._markers.set_color(
            self._colors.to_rgba(self._field[time_step, ..., 0].ravel())
        )


class StreamPlot(AnimatedPlot):
    """Animated streamlines of a 2D PDE vector field (Cartesian or
    polar)."""

    def __init__(
        self, y: np.ndarray,
        mesh: Mesh, vertex_oriented: bool,
        n_frames: int = 100, interval: int = 100,
        color: str = "black",
        density: float = 1.0,
        **_,
    ):
        _require_field(y, mesh, vertex_oriented, 2, None)
        grids = mesh.coordinate_grids(vertex_oriented)
        self._color = color
        self._density = density
        self._polar = (
            mesh.coordinate_system_type == CoordinateSystem.POLAR
        )
        figure = _pyplot().figure()

        if self._polar:
            # matplotlib's polar axes take (theta, r): swap the mesh's
            # (r, theta) axis order and components
            (radial, _), (angular, _) = (
                mesh.x_intervals[0],
                mesh.x_intervals[1],
            )
            self._x_bounds = (mesh.x_intervals[1][0], mesh.x_intervals[1][1])
            self._y_bounds = (0.0, mesh.x_intervals[0][1])
            self._grid_x, self._grid_y = grids[1], grids[0]
            self._u, self._v = y[..., 1], y[..., 0]
            self._axes = figure.add_subplot(projection="polar")
        else:
            self._x_bounds = tuple(mesh.x_intervals[0])
            self._y_bounds = tuple(mesh.x_intervals[1])
            # streamplot expects row-major (y, x) grids: transpose
            self._grid_x = grids[0].T
            self._grid_y = grids[1].T
            self._u = y[..., 0].transpose([0, 2, 1])
            self._v = y[..., 1].transpose([0, 2, 1])
            self._axes = figure.add_subplot()

        self._streams = None
        super().__init__(figure, y.shape[0], n_frames, interval)

    def _trace(self, time_step: int):
        return self._axes.streamplot(
            self._grid_x,
            self._grid_y,
            self._u[time_step, ...],
            self._v[time_step, ...],
            color=self._color,
            density=self._density,
        )

    def _render_initial(self):
        axes = self._axes
        axes.clear()
        self._streams = self._trace(0)
        axes.set_xlim(*self._x_bounds)
        axes.set_ylim(*self._y_bounds)
        if not self._polar:
            axes.axis("scaled")
            axes.set_xlabel("x")
            axes.set_ylabel("y")

    def _render_frame(self, time_step: int):
        # streamplot cannot update in place: drop the arrow patches and
        # line collection, then retrace
        for arrow in list(self._axes.patches):
            arrow.remove()
        self._streams.lines.remove()
        self._streams = self._trace(time_step)


class QuiverPlot(AnimatedPlot):
    """Animated arrow field of a 2D/3D PDE vector field; curvilinear
    components are first rotated into Cartesian frame via the mesh's
    unit-vector grids."""

    def __init__(
        self, y: np.ndarray,
        mesh: Mesh, vertex_oriented: bool,
        n_frames: int = 100, interval: int = 100,
        normalize: bool = False,
        pivot: str = "middle",
        quiver_scale: float = 10.0,
        **_,
    ):
        _require_field(y, mesh, vertex_oriented, (2, 3), None)
        self._grids = mesh.cartesian_coordinate_grids(vertex_oriented)
        unit_vectors = mesh.unit_vector_grids(vertex_oriented)
        cartesian_field = sum(
            y[..., axis : axis + 1] * unit_vectors[axis][np.newaxis, ...]
            for axis in range(mesh.dimensions)
        )
        self._spatial = mesh.dimensions
        self._normalize = normalize
        self._pivot = pivot
        self._arrows = None
        figure = _pyplot().figure()

        if self._spatial == 2:
            u = np.array(cartesian_field[..., 0])
            v = np.array(cartesian_field[..., 1])
            if normalize:
                length = np.hypot(u, v)
                nonzero = length > 0.0
                u[nonzero] /= length[nonzero]
                v[nonzero] /= length[nonzero]
            self._components = (u, v)
            self._arrow_scale = 1.0 / quiver_scale
            self._axes = figure.add_subplot()
        else:
            self._components = tuple(
                cartesian_field[..., axis] * quiver_scale
                for axis in range(3)
            )
            self._axes = figure.add_subplot(projection="3d")

        super().__init__(
            figure, cartesian_field.shape[0], n_frames, interval
        )

    def _render_initial(self):
        axes = self._axes
        if self._spatial == 2:
            axes.clear()
            axes.set_xlabel("x")
            axes.set_ylabel("y")
            self._arrows = axes.quiver(
                *self._grids,
                self._components[0][0, ...],
                self._components[1][0, ...],
                pivot=self._pivot,
                angles="xy",
                scale_units="xy",
                scale=self._arrow_scale,
            )
            axes.axis("scaled")
        else:
            axes.clear()
            self._arrows = axes.quiver(
                *self._grids,
                *[c[0, ...] for c in self._components],
                pivot=self._pivot,
                normalize=self._normalize,
            )
            axes.set_xlabel("x")
            axes.set_ylabel("y")
            axes.set_zlabel("z")
            axes.set_box_aspect(tuple(np.ptp(g) for g in self._grids))

    def _render_frame(self, time_step: int):
        if self._spatial == 2:
            self._arrows.set_UVC(
                self._components[0][time_step, ...],
                self._components[1][time_step, ...],
            )
        else:
            self._arrows.remove()
            self._arrows = self._axes.quiver(
                *self._grids,
                *[c[time_step, ...] for c in self._components],
                pivot=self._pivot,
                normalize=self._normalize,
            )
