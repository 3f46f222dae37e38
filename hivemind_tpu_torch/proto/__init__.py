"""Protobuf messages of the wire layer (``runtime.proto``), of the DHT
(``dht.proto``) and of averaging (``averaging.proto``), declared by field tables on
the port's own proto3 codec (``wire.py``): no ``google.protobuf``."""
