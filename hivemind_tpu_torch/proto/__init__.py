"""Protobuf messages of the wire layer (``runtime.proto``) and of the DHT
(``dht.proto``), declared by field tables on the port's own proto3 codec
(``wire.py``): no ``google.protobuf``."""
