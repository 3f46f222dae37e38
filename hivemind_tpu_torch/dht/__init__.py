"""The DHT (the port of hivemind_tpu/dht/): Kademlia routing, storage, the
ping/store/find protocol, beam-search traversal, the DHTNode and the sync ``DHT``
facade, on the JAX package's wire, so port and JAX peers share one swarm; and
the schema validator (``schema.py``, written without pydantic)."""

from hivemind_tpu_torch.dht.crypto import Ed25519SignatureValidator
from hivemind_tpu_torch.dht.dht import DHT
from hivemind_tpu_torch.dht.node import Blacklist, DHTNode
from hivemind_tpu_torch.dht.protocol import DHTProtocol
from hivemind_tpu_torch.dht.routing import DHTID, DHTKey, PeerInfo, RoutingTable, Subkey
from hivemind_tpu_torch.dht.schema import BytesWithEd25519PublicKey, SchemaValidator
from hivemind_tpu_torch.dht.storage import DHTLocalStorage, DictionaryDHTValue
from hivemind_tpu_torch.dht.validation import CompositeValidator, DHTRecord, RecordValidatorBase
