"""Reflection-based RPC services (the port's copy of hivemind_tpu/p2p/servicer.py).

Subclass ``ServicerBase`` and define ``async def rpc_*`` methods with protobuf type
annotations; ``add_p2p_handlers`` registers them all, and ``get_stub`` builds a caller
object with matching methods. Streaming is inferred from AsyncIterator annotations on
the request parameter / return type.
"""

from __future__ import annotations

import asyncio
import collections.abc
import typing
from dataclasses import dataclass
from typing import Any, Optional, Type

from hivemind_tpu_torch.p2p.p2p import P2P, P2PContext
from hivemind_tpu_torch.p2p.peer_id import PeerID
from hivemind_tpu_torch.utils.asyncio_utils import aiter_with_timeout


@dataclass
class _RPCSpec:
    method_name: str
    request_type: Type
    response_type: Type
    stream_input: bool
    stream_output: bool
    idempotent: bool = False



def _unwrap_iterator(annotation) -> tuple[Any, bool]:
    """(inner_type, True) for AsyncIterator/Iterable/Generator annotations, else
    (annotation, False). typing.get_origin resolves typing aliases to collections.abc."""
    origin = typing.get_origin(annotation)
    if origin in (
        collections.abc.AsyncIterator,
        collections.abc.AsyncIterable,
        collections.abc.AsyncGenerator,
    ):
        return typing.get_args(annotation)[0], True
    return annotation, False


class StubBase:
    """Base for generated stubs: holds the p2p node, target peer, and namespace."""

    def __init__(self, p2p: P2P, peer_id: PeerID, namespace: Optional[str]):
        self._p2p = p2p
        self._peer_id = peer_id
        self._namespace = namespace


class ServicerBase:
    """A collection of rpc_* methods exposed over P2P under
    ``{namespace::}ClassName.method`` handles."""

    _rpc_specs: Optional[list] = None
    _stub_class: Optional[Type[StubBase]] = None

    @classmethod
    def _collect_rpc_specs(cls) -> list:
        if cls.__dict__.get("_rpc_specs") is not None:
            return cls.__dict__["_rpc_specs"]
        specs = []
        for name in sorted(dir(cls)):
            if not name.startswith("rpc_"):
                continue
            method = getattr(cls, name)
            hints = typing.get_type_hints(method)
            params = [p for p in hints if p not in ("return",)]
            # expected signature: (self), request, context
            request_param = None
            for param in params:
                if hints[param] is P2PContext:
                    continue
                request_param = param
            assert request_param is not None, f"{cls.__name__}.{name} must annotate its request parameter"
            request_type, stream_input = _unwrap_iterator(hints[request_param])
            response_type, stream_output = _unwrap_iterator(hints.get("return"))
            assert response_type is not None, f"{cls.__name__}.{name} must annotate its return type"
            # subclasses whitelist safe-to-retry RPCs (reads or set-semantics writes)
            # via ``_idempotent_rpcs``; everything else fails loudly on an ambiguous
            # connection loss instead of risking a double-applied side effect
            idempotent = name in getattr(cls, "_idempotent_rpcs", frozenset())
            specs.append(_RPCSpec(name, request_type, response_type, stream_input, stream_output, idempotent))
        cls._rpc_specs = specs
        return specs

    @classmethod
    def _handle_name(cls, method_name: str, namespace: Optional[str]) -> str:
        # subclasses may pin a shared wire name (e.g. every averager subclass speaks
        # as "DecentralizedAverager") so heterogeneous peers interoperate
        class_name = getattr(cls, "_class_handle_name", cls.__name__)
        if namespace is not None:
            return f"{namespace}::{class_name}.{method_name}"
        return f"{class_name}.{method_name}"

    async def add_p2p_handlers(
        self, p2p: P2P, wrapper: Optional[object] = None, *, namespace: Optional[str] = None
    ) -> None:
        """Register all rpc_* methods on the given p2p node. ``wrapper`` substitutes the
        bound target (used by auth wrappers)."""
        target = wrapper if wrapper is not None else self
        for spec in type(self)._collect_rpc_specs():
            await p2p.add_protobuf_handler(
                self._handle_name(spec.method_name, namespace),
                getattr(target, spec.method_name),
                spec.request_type,
                stream_input=spec.stream_input,
                stream_output=spec.stream_output,
            )

    async def remove_p2p_handlers(self, p2p: P2P, *, namespace: Optional[str] = None) -> None:
        for spec in type(self)._collect_rpc_specs():
            await p2p.remove_protobuf_handler(self._handle_name(spec.method_name, namespace))

    @classmethod
    def get_stub(cls, p2p: P2P, peer_id: PeerID, *, namespace: Optional[str] = None) -> StubBase:
        """A caller object with one async method per rpc_*; unary methods accept
        ``timeout=``."""
        if cls.__dict__.get("_stub_class") is None:
            methods = {}
            for spec in cls._collect_rpc_specs():
                methods[spec.method_name] = cls._make_caller(spec)
            cls._stub_class = type(f"{cls.__name__}Stub", (StubBase,), methods)
        return cls.__dict__["_stub_class"](p2p, peer_id, namespace)

    @classmethod
    def _make_caller(cls, spec: _RPCSpec):
        handle = spec.method_name

        if spec.stream_output:

            def stream_caller(self: StubBase, requests, timeout: Optional[float] = None):
                name = cls._handle_name(handle, self._namespace)
                iterator = self._p2p.iterate_protobuf_handler(
                    self._peer_id, name, requests, spec.response_type
                )
                if timeout is not None:
                    return aiter_with_timeout(iterator, timeout)
                return iterator

            stream_caller.__name__ = handle
            return stream_caller

        async def unary_caller(self: StubBase, request, timeout: Optional[float] = None):
            name = cls._handle_name(handle, self._namespace)
            if spec.stream_input:
                # client-streaming with single response: iterate and keep the last
                result = None
                iterator = self._p2p.iterate_protobuf_handler(
                    self._peer_id, name, request, spec.response_type
                )
                if timeout is not None:
                    iterator = aiter_with_timeout(iterator, timeout)
                async for item in iterator:
                    result = item
                return result
            return await asyncio.wait_for(
                self._p2p.call_protobuf_handler(
                    self._peer_id, name, request, spec.response_type, idempotent=spec.idempotent
                ),
                timeout=timeout,
            )

        unary_caller.__name__ = handle
        return unary_caller
