"""The port's own copy of the optax it needs: gradient transformations over trees of
torch tensors (no JAX module corresponds, because optax is a library).

A tree is nested dicts, tuples, lists and NamedTuples with tensors at the leaves;
:func:`tree_flatten_with_path` orders the leaves as ``jax.tree_util`` does (dict keys
sorted, sequences in order) and names them with the same key kinds (``DictKey``,
``SequenceKey``, ``GetAttrKey``); :func:`tree_unflatten` refills a tree's structure. States follow optax's structure: a
``chain`` state is a tuple of its members' states, Adam's is ``ScaleByAdamState(count,
mu, nu)`` and stateless members hold ``EmptyState()``. Every state tensor lives on the
parameters' device.

The arithmetic is optax's, in its operations and order, in float32 tensors (powers and
schedules included, never Python floats): ``scale_by_adam`` bias-corrects with ``count
+ 1``, puts ``eps`` outside the square root and ``eps_root`` inside; ``scale_by_trust_ratio``
works per leaf with a ratio of 1 when either norm is 0; ``clip_by_global_norm`` scales by
``max_norm / g_norm`` only when ``g_norm >= max_norm``; schedules read the state's count
before its increment.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

Schedule = Callable[[torch.Tensor], Any]
ScalarOrSchedule = Union[float, Schedule]

# ------------------------------------------------------------------ trees


@dataclasses.dataclass(frozen=True)
class DictKey:
    key: Any


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    idx: int


@dataclasses.dataclass(frozen=True)
class GetAttrKey:
    name: str


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(key, child) pairs of an inner node in jax.tree_util's order, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(DictKey(key), node[key]) for key in sorted(node)]
    if _is_namedtuple(node):
        return [(GetAttrKey(name), getattr(node, name)) for name in node._fields]
    if isinstance(node, (tuple, list)):
        return [(SequenceKey(i), child) for i, child in enumerate(node)]
    return None


def _rebuild(node, children: list):
    if node is None:
        return None
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def tree_flatten_with_path(tree) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf)]`` in jax.tree_util's leaf order."""
    children = _children(tree)
    if children is None:
        return [((), tree)]
    return [((key, *path), leaf) for key, child in children for path, leaf in tree_flatten_with_path(child)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(structure, leaves: Sequence) -> Any:
    """``structure`` (any tree) with its leaves replaced, in flatten order, by ``leaves``."""
    iterator = iter(leaves)

    def fill(node):
        children = _children(node)
        if children is None:
            return next(iterator)
        return _rebuild(node, [fill(child) for _, child in children])

    return fill(structure)


def tree_map(fn: Callable, tree, *rest) -> Any:
    others = [tree_leaves(other) for other in rest]
    return tree_unflatten(tree, [fn(*items) for items in zip(tree_leaves(tree), *others)])


# ------------------------------------------------------------------ transformations


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32, shape ()
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # int32, shape ()


class TraceState(NamedTuple):
    trace: Any


def _device(tree) -> torch.device:
    leaves = [leaf for leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def _zero_count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    top = torch.iinfo(count.dtype).max
    return torch.where(count < top, count + 1, torch.full_like(count, top))


def _empty_init(params) -> EmptyState:
    return EmptyState()


def identity() -> GradientTransformation:
    return GradientTransformation(_empty_init, lambda updates, state, params=None: (updates, state))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init_fn(params):
        return tuple(t.init(params) for t in transforms)

    def update_fn(updates, state, params=None):
        if len(state) != len(transforms):
            raise ValueError("the chain's state does not match its transformations; call init first")
        new_state = []
        for transform, member_state in zip(transforms, state):
            updates, member_state = transform.update(updates, member_state, params)
            new_state.append(member_state)
        return updates, tuple(new_state)

    return GradientTransformation(init_fn, update_fn)


def _bias_correction(moment, decay: float, count: torch.Tensor):
    # a float32 power of a float32 count: what optax's jitted bias correction computes
    correction = 1 - torch.pow(_f32(decay, count.device), count.to(torch.float32))
    return tree_map(lambda t: t / correction.to(t.dtype), moment)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    def init_fn(params):
        zeros = lambda p: torch.zeros_like(p)
        return ScaleByAdamState(count=_zero_count(params), mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def update_fn(updates, state, params=None):
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates, state.nu)
        count_inc = safe_increment(state.count)
        mu_hat = _bias_correction(mu, b1, count_inc)
        nu_hat = _bias_correction(nu, b2, count_inc)
        updates = tree_map(lambda m, v: m / (torch.sqrt(v + eps_root) + eps), mu_hat, nu_hat)
        return updates, ScaleByAdamState(count=count_inc, mu=mu, nu=nu)

    return GradientTransformation(init_fn, update_fn)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    def update_fn(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the parameters")
        return tree_map(lambda g, p: g + weight_decay * p, updates, params), state

    return GradientTransformation(_empty_init, update_fn)


def _safe_norm(x: torch.Tensor, min_norm: float) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x))
    return torch.where(norm <= min_norm, _f32(min_norm, x.device).to(norm.dtype), norm)


def scale_by_trust_ratio(min_norm: float = 0.0, trust_coefficient: float = 1.0, eps: float = 0.0) -> GradientTransformation:
    def scale_update(update, param):
        param_norm = _safe_norm(param, min_norm)
        update_norm = _safe_norm(update, min_norm)
        trust_ratio = trust_coefficient * param_norm / (update_norm + eps)
        zero_norm = torch.logical_or(param_norm == 0.0, update_norm == 0.0)
        return update * torch.where(zero_norm, torch.ones((), dtype=param.dtype, device=param.device), trust_ratio)

    def update_fn(updates, state, params=None):
        if params is None:
            raise ValueError("scale_by_trust_ratio needs the parameters")
        return tree_map(scale_update, updates, params), state

    return GradientTransformation(_empty_init, update_fn)


def scale(step_size: float) -> GradientTransformation:
    return GradientTransformation(_empty_init, lambda updates, state, params=None: (
        tree_map(lambda g: step_size * g, updates), state))


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransformation:
    def init_fn(params):
        return ScaleByScheduleState(count=_zero_count(params))

    def update_fn(updates, state, params=None):
        step_size = step_size_fn(state.count)
        updates = tree_map(lambda g: torch.as_tensor(step_size, dtype=g.dtype, device=g.device) * g, updates)
        return updates, ScaleByScheduleState(count=safe_increment(state.count))

    return GradientTransformation(init_fn, update_fn)


def scale_by_learning_rate(learning_rate: ScalarOrSchedule, *, flip_sign: bool = True) -> GradientTransformation:
    sign = -1 if flip_sign else 1
    if callable(learning_rate):
        return scale_by_schedule(lambda count: sign * learning_rate(count))
    return scale(sign * learning_rate)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update_fn(updates, state, params=None):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(updates)))
        trigger = g_norm < max_norm
        updates = tree_map(lambda t: torch.where(trigger, t, (t / g_norm.to(t.dtype)) * max_norm), updates)
        return updates, state

    return GradientTransformation(_empty_init, update_fn)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    def init_fn(params):
        return TraceState(trace=tree_map(torch.zeros_like, params))

    def update_fn(updates, state, params=None):
        step = lambda g, t: g + decay * t
        new_trace = tree_map(step, updates, state.trace)
        updates = tree_map(step, updates, new_trace) if nesterov else new_trace
        return updates, TraceState(trace=new_trace)

    return GradientTransformation(init_fn, update_fn)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ------------------------------------------------------------------ aliases


def adam(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps, eps_root), scale_by_learning_rate(learning_rate))


def adamw(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps, eps_root), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def sgd(learning_rate: ScalarOrSchedule, momentum: Optional[float] = None, nesterov: bool = False) -> GradientTransformation:
    return chain(trace(momentum, nesterov) if momentum is not None else identity(), scale_by_learning_rate(learning_rate))


def lamb(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         eps_root: float = 0.0, weight_decay: float = 0.0) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps, eps_root), add_decayed_weights(weight_decay), scale_by_trust_ratio(),
                 scale_by_learning_rate(learning_rate))


# ------------------------------------------------------------------ schedules


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float, transition_steps: int, transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return constant_schedule(init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.clamp(count - transition_begin, 0, transition_steps)
        frac = 1 - count.to(torch.float32) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        output = _f32(schedules[0](step), step.device)
        for boundary, member in zip(boundaries, schedules[1:]):
            output = torch.where(step < boundary, output, _f32(member(step - boundary), step.device))
        return output

    return schedule
