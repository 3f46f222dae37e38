"""Protobuf messages of the wire layer (``runtime.proto``; generated module
``runtime_pb2``, checked in so the package needs no build step). Only the
wire layer imports them: the card's path needs no protobuf."""
