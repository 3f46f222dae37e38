// hm_relayd: the relay daemon of hivemind_tpu_torch — the native transport component.
// The port's copy of the JAX package's daemon source, with the same frames, banner lines
// and argv, so either package's client can use either daemon.
//
// Role parity: the circuit-relay v2 capability of the reference's go-libp2p daemon
// (hivemind/p2p/p2p_daemon.py:114-137 enables relay + auto-relay): peers behind NAT
// register here over an OUTBOUND connection and become dialable through the relay.
// Security model: the relay splices raw bytes; peers run their end-to-end Noise
// handshake THROUGH it, so the relay only ever sees AEAD ciphertext.
//
// Control protocol (length-prefixed frames: u32 big-endian length + payload):
//   REGISTER  'R' <peer_id bytes>        -> 'C' <32B challenge>  (when libcrypto is
//             available; peer must prove it owns the Ed25519 key its peer_id hashes)
//             -> 'O' directly in legacy mode (no libcrypto on the host)
//   PROOF     'P' <32B ed25519 pubkey> <64B signature>  -> 'O'  (signature over
//             "hivemind-relay-register:" + challenge + peer_id; sha256(pubkey) must
//             equal the multihash digest in peer_id). A VALID proof also evicts any
//             stale control line for the same peer_id — only the key owner can, so
//             a NAT-rebound peer reclaims its identity immediately instead of
//             waiting for TCP keepalive to reap the dead line.
//   HANDSHAKE 'H' <32B client X25519 eph>  -> 'S' <32B relay eph> <32B relay
//             Ed25519 pub> <64B sig over "hivemind-relay-hs:" + client_eph +
//             relay_eph>. Derives per-direction ChaCha20-Poly1305 keys
//             (HKDF-SHA256 of the ECDH secret, salt "hivemind-relay-hs", info
//             "control"; nonce = 4 zero bytes + LE64 counter); every later control
//             frame on the conn is sealed, so INCOMING tokens and registration
//             proofs are opaque to on-path observers. Clients that PIN the relay
//             identity also defeat a malicious relay proxying the registration
//             challenge to a second relay (the proxy cannot read or re-wrap the
//             sealed proof); unpinned trust-on-first-use still leaves that window
//             on the very first connect, like SSH.
//   DIAL      'D' <16B token> <target_id>-> 'O' then splice  (sent on a FRESH conn)
//   ACCEPT    'A' <16B token>            -> 'O' then splice  (fresh conn from target)
//   INCOMING  'I' <16B token>            relay -> target's control line
//   WHOAMI    'W'                        -> 'O' <ip:port>  (the conn's observed
//             public endpoint — the STUN-style observation NATed peers need for
//             hole punching; role parity with libp2p identify/observed-addr)
//   PROXY     'X' <u16 BE port> <ip>     -> 'O' once the outbound connect lands.
//             Local DATA-PLANE proxy: the daemon terminates the peer's channel
//             AEAD so Python ships plaintext frames over loopback and the native
//             side does ChaCha20-Poly1305 + wire IO (the reference keeps its whole
//             transport in the Go daemon the same way, p2p_daemon.py:84-147).
//             After 'O': local frame #1 (hello) crosses raw, frame #2 must be
//             'K' <send_key 32><recv_key 32><LE64 send_ctr><LE64 recv_ctr>
//             (consumed), frames #3+ are sealed toward the wire; wire frame #1
//             (peer hello) crosses raw, #2+ are opened with recv_key. Ciphertext
//             arriving before 'K' is held, so the upgrade cannot race.
//   LISTEN    'Y' <u16 BE public_port> <u16 BE local_port> -> 'O' <u16 actual>.
//             INBOUND data-plane proxy: the daemon binds the PUBLIC listener
//             and forwards each accepted wire conn to the local server at
//             127.0.0.1:local_port as a ProxyRemote/ProxyLocal pair — the same
//             frame machine as 'X', fed by the responder-side handshake (hello
//             #1, 'K' #2, sealed #3+), so a busy server's cipher work for BOTH
//             directions leaves the Python event loop. The listener lives
//             exactly as long as the control conn that registered it.
// After 'O' on a DIAL/ACCEPT pair the two sockets are spliced byte-for-byte.
//
// Usage: hm_relayd [port] [identity_file] [unix_socket_path] [bind_host]
//
// With a unix_socket_path, the daemon ALSO listens on a 0600 AF_UNIX socket —
// the trust boundary for the local data-plane proxy hop: the 'K' upgrade ships
// session AEAD keys, and a TCP loopback port offers no peer credential, so
// multi-user hosts must hand keys over the unix socket (filesystem-permission
// enforced), never the port.
//   identity_file (optional): raw 32-byte Ed25519 private key, loaded if present,
//   created (0600) otherwise — keeps the relay identity stable across restarts so
//   client pins keep working.
// Build: g++ -O2 -std=c++17 -o hm_relayd hm_relayd.cpp -ldl
// (hivemind_tpu_torch/ops/_build_relayd.py does so into build/hivemind_tpu_torch/)

#include <arpa/inet.h>
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/random.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

#include <chrono>
#include <map>
#include <string>
#include <vector>

static constexpr size_t MAX_FRAME = 1 << 20;       // control frames only
static constexpr size_t SPLICE_BUF = 1 << 16;      // per-direction pipe buffer
static constexpr int PENDING_DIAL_TTL_MS = 30000;  // unmatched dials expire
// Backpressure water marks. epoll here is level-triggered, so merely breaking out
// of the read loop is NOT backpressure (the next epoll_wait re-fires EPOLLIN and
// reads another 64 KiB): above HIGH_WATER the reading fd DROPS EPOLLIN interest and
// is re-armed from on_writable once the partner drains below LOW_WATER — bounding
// each direction at HIGH_WATER + one read (~576 KiB).
static constexpr size_t HIGH_WATER = 8 * SPLICE_BUF;
static constexpr size_t LOW_WATER = 2 * SPLICE_BUF;
static constexpr int FLUSH_TTL_MS = 60000;  // closing_after_flush conns expire

static double now_ms() {
  using namespace std::chrono;
  return duration_cast<duration<double, std::milli>>(steady_clock::now().time_since_epoch()).count();
}

// ---- Ed25519 registration proof via the system libcrypto ----------------------
// This image ships libcrypto.so.3 but no OpenSSL headers, so the few stable-ABI
// entry points needed for one-shot Ed25519 verification are declared here and
// resolved with dlopen at startup. If libcrypto is absent the daemon degrades to
// the legacy unauthenticated first-registration-wins behavior (and says so).
namespace relay_crypto {
typedef struct evp_pkey_st EVP_PKEY;
typedef struct evp_md_ctx_st EVP_MD_CTX;
static constexpr int EVP_PKEY_ED25519 = 1087;  // NID_ED25519, stable since 1.1.1

static EVP_PKEY* (*new_raw_public_key)(int, void*, const unsigned char*, size_t) = nullptr;
static void (*pkey_free)(EVP_PKEY*) = nullptr;
static EVP_MD_CTX* (*md_ctx_new)() = nullptr;
static void (*md_ctx_free)(EVP_MD_CTX*) = nullptr;
static int (*digest_verify_init)(EVP_MD_CTX*, void**, const void*, void*, EVP_PKEY*) = nullptr;
static int (*digest_verify)(EVP_MD_CTX*, const unsigned char*, size_t, const unsigned char*, size_t) = nullptr;
static unsigned char* (*sha256_fn)(const unsigned char*, size_t, unsigned char*) = nullptr;

// additional entry points for the encrypted control channel (X25519 ECDH +
// Ed25519 relay identity + HKDF-SHA256 + ChaCha20-Poly1305 AEAD)
typedef struct evp_pkey_ctx_st EVP_PKEY_CTX;
typedef struct evp_cipher_ctx_st EVP_CIPHER_CTX;
typedef struct evp_cipher_st EVP_CIPHER;
typedef struct evp_md_st EVP_MD;
static constexpr int EVP_PKEY_X25519 = 1034;  // NID_X25519
static constexpr int CTRL_AEAD_GET_TAG = 0x10, CTRL_AEAD_SET_TAG = 0x11;

static EVP_PKEY* (*new_raw_private_key)(int, void*, const unsigned char*, size_t) = nullptr;
static int (*get_raw_private_key)(const EVP_PKEY*, unsigned char*, size_t*) = nullptr;
static EVP_PKEY_CTX* (*pkey_ctx_new_id)(int, void*) = nullptr;
static void (*pkey_ctx_free)(EVP_PKEY_CTX*) = nullptr;
static int (*keygen_init)(EVP_PKEY_CTX*) = nullptr;
static int (*keygen)(EVP_PKEY_CTX*, EVP_PKEY**) = nullptr;
static int (*get_raw_public_key)(const EVP_PKEY*, unsigned char*, size_t*) = nullptr;
static int (*digest_sign_init)(EVP_MD_CTX*, EVP_PKEY_CTX**, const EVP_MD*, void*, EVP_PKEY*) = nullptr;
static int (*digest_sign)(EVP_MD_CTX*, unsigned char*, size_t*, const unsigned char*, size_t) = nullptr;
static int (*derive_init)(EVP_PKEY_CTX*) = nullptr;
static int (*derive_set_peer)(EVP_PKEY_CTX*, EVP_PKEY*) = nullptr;
static int (*derive)(EVP_PKEY_CTX*, unsigned char*, size_t*) = nullptr;
static EVP_PKEY_CTX* (*pkey_ctx_new)(EVP_PKEY*, void*) = nullptr;
static unsigned char* (*hmac_fn)(const EVP_MD*, const void*, int, const unsigned char*, size_t,
                                 unsigned char*, unsigned int*) = nullptr;
static const EVP_MD* (*sha256_md)() = nullptr;
static EVP_CIPHER_CTX* (*cipher_ctx_new)() = nullptr;
static void (*cipher_ctx_free)(EVP_CIPHER_CTX*) = nullptr;
static const EVP_CIPHER* (*chacha20_poly1305)() = nullptr;
static int (*encrypt_init)(EVP_CIPHER_CTX*, const EVP_CIPHER*, void*, const unsigned char*, const unsigned char*) = nullptr;
static int (*encrypt_update)(EVP_CIPHER_CTX*, unsigned char*, int*, const unsigned char*, int) = nullptr;
static int (*encrypt_final)(EVP_CIPHER_CTX*, unsigned char*, int*) = nullptr;
static int (*decrypt_init)(EVP_CIPHER_CTX*, const EVP_CIPHER*, void*, const unsigned char*, const unsigned char*) = nullptr;
static int (*decrypt_update)(EVP_CIPHER_CTX*, unsigned char*, int*, const unsigned char*, int) = nullptr;
static int (*decrypt_final)(EVP_CIPHER_CTX*, unsigned char*, int*) = nullptr;
static int (*cipher_ctx_ctrl)(EVP_CIPHER_CTX*, int, int, void*) = nullptr;

static bool channel_available = false;  // handshake ops resolved

static bool load() {
  void* lib = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_LOCAL);
  if (!lib) lib = dlopen("libcrypto.so.1.1", RTLD_NOW | RTLD_LOCAL);
  if (!lib) lib = dlopen("libcrypto.so", RTLD_NOW | RTLD_LOCAL);
  if (!lib) return false;
  new_raw_public_key = (decltype(new_raw_public_key))dlsym(lib, "EVP_PKEY_new_raw_public_key");
  pkey_free = (decltype(pkey_free))dlsym(lib, "EVP_PKEY_free");
  md_ctx_new = (decltype(md_ctx_new))dlsym(lib, "EVP_MD_CTX_new");
  md_ctx_free = (decltype(md_ctx_free))dlsym(lib, "EVP_MD_CTX_free");
  digest_verify_init = (decltype(digest_verify_init))dlsym(lib, "EVP_DigestVerifyInit");
  digest_verify = (decltype(digest_verify))dlsym(lib, "EVP_DigestVerify");
  sha256_fn = (decltype(sha256_fn))dlsym(lib, "SHA256");

  new_raw_private_key = (decltype(new_raw_private_key))dlsym(lib, "EVP_PKEY_new_raw_private_key");
  get_raw_private_key = (decltype(get_raw_private_key))dlsym(lib, "EVP_PKEY_get_raw_private_key");
  pkey_ctx_new_id = (decltype(pkey_ctx_new_id))dlsym(lib, "EVP_PKEY_CTX_new_id");
  pkey_ctx_free = (decltype(pkey_ctx_free))dlsym(lib, "EVP_PKEY_CTX_free");
  keygen_init = (decltype(keygen_init))dlsym(lib, "EVP_PKEY_keygen_init");
  keygen = (decltype(keygen))dlsym(lib, "EVP_PKEY_keygen");
  get_raw_public_key = (decltype(get_raw_public_key))dlsym(lib, "EVP_PKEY_get_raw_public_key");
  digest_sign_init = (decltype(digest_sign_init))dlsym(lib, "EVP_DigestSignInit");
  digest_sign = (decltype(digest_sign))dlsym(lib, "EVP_DigestSign");
  derive_init = (decltype(derive_init))dlsym(lib, "EVP_PKEY_derive_init");
  derive_set_peer = (decltype(derive_set_peer))dlsym(lib, "EVP_PKEY_derive_set_peer");
  derive = (decltype(derive))dlsym(lib, "EVP_PKEY_derive");
  pkey_ctx_new = (decltype(pkey_ctx_new))dlsym(lib, "EVP_PKEY_CTX_new");
  hmac_fn = (decltype(hmac_fn))dlsym(lib, "HMAC");
  sha256_md = (decltype(sha256_md))dlsym(lib, "EVP_sha256");
  cipher_ctx_new = (decltype(cipher_ctx_new))dlsym(lib, "EVP_CIPHER_CTX_new");
  cipher_ctx_free = (decltype(cipher_ctx_free))dlsym(lib, "EVP_CIPHER_CTX_free");
  chacha20_poly1305 = (decltype(chacha20_poly1305))dlsym(lib, "EVP_chacha20_poly1305");
  encrypt_init = (decltype(encrypt_init))dlsym(lib, "EVP_EncryptInit_ex");
  encrypt_update = (decltype(encrypt_update))dlsym(lib, "EVP_EncryptUpdate");
  encrypt_final = (decltype(encrypt_final))dlsym(lib, "EVP_EncryptFinal_ex");
  decrypt_init = (decltype(decrypt_init))dlsym(lib, "EVP_DecryptInit_ex");
  decrypt_update = (decltype(decrypt_update))dlsym(lib, "EVP_DecryptUpdate");
  decrypt_final = (decltype(decrypt_final))dlsym(lib, "EVP_DecryptFinal_ex");
  cipher_ctx_ctrl = (decltype(cipher_ctx_ctrl))dlsym(lib, "EVP_CIPHER_CTX_ctrl");

  channel_available = new_raw_private_key && get_raw_private_key &&
                      pkey_ctx_new_id && pkey_ctx_free && keygen_init && keygen &&
                      get_raw_public_key && digest_sign_init && digest_sign && derive_init &&
                      derive_set_peer && derive && pkey_ctx_new && hmac_fn && sha256_md &&
                      cipher_ctx_new && cipher_ctx_free && chacha20_poly1305 && encrypt_init &&
                      encrypt_update && encrypt_final && decrypt_init && decrypt_update &&
                      decrypt_final && cipher_ctx_ctrl;
  return new_raw_public_key && pkey_free && md_ctx_new && md_ctx_free &&
         digest_verify_init && digest_verify && sha256_fn;
}

static bool available = false;

static bool sha256(const std::string& data, unsigned char out[32]) {
  if (!available) return false;
  return sha256_fn((const unsigned char*)data.data(), data.size(), out) != nullptr;
}

static bool ed25519_verify(const std::string& pubkey_raw, const std::string& message,
                           const std::string& signature) {
  if (!available || pubkey_raw.size() != 32 || signature.size() != 64) return false;
  EVP_PKEY* key = new_raw_public_key(EVP_PKEY_ED25519, nullptr,
                                     (const unsigned char*)pubkey_raw.data(), pubkey_raw.size());
  if (!key) return false;
  EVP_MD_CTX* ctx = md_ctx_new();
  bool ok = false;
  if (ctx && digest_verify_init(ctx, nullptr, nullptr, nullptr, key) == 1) {
    ok = digest_verify(ctx, (const unsigned char*)signature.data(), signature.size(),
                       (const unsigned char*)message.data(), message.size()) == 1;
  }
  if (ctx) md_ctx_free(ctx);
  pkey_free(key);
  return ok;
}
static EVP_PKEY* generate_key(int type) {
  EVP_PKEY_CTX* ctx = pkey_ctx_new_id(type, nullptr);
  if (!ctx) return nullptr;
  EVP_PKEY* key = nullptr;
  if (keygen_init(ctx) != 1 || keygen(ctx, &key) != 1) key = nullptr;
  pkey_ctx_free(ctx);
  return key;
}

static bool raw_public(EVP_PKEY* key, unsigned char out[32]) {
  size_t len = 32;
  return get_raw_public_key(key, out, &len) == 1 && len == 32;
}

static bool ed25519_sign(EVP_PKEY* key, const std::string& message, unsigned char sig[64]) {
  EVP_MD_CTX* ctx = md_ctx_new();
  if (!ctx) return false;
  size_t siglen = 64;
  bool ok = digest_sign_init(ctx, nullptr, nullptr, nullptr, key) == 1 &&
            digest_sign(ctx, sig, &siglen, (const unsigned char*)message.data(),
                        message.size()) == 1 &&
            siglen == 64;
  md_ctx_free(ctx);
  return ok;
}

static bool x25519_shared(EVP_PKEY* own, const unsigned char peer_pub[32],
                          unsigned char out[32]) {
  EVP_PKEY* peer = new_raw_public_key(EVP_PKEY_X25519, nullptr, peer_pub, 32);
  if (!peer) return false;
  EVP_PKEY_CTX* ctx = pkey_ctx_new(own, nullptr);
  size_t len = 32;
  bool ok = ctx && derive_init(ctx) == 1 && derive_set_peer(ctx, peer) == 1 &&
            derive(ctx, out, &len) == 1 && len == 32;
  if (ctx) pkey_ctx_free(ctx);
  pkey_free(peer);
  return ok;
}

// HKDF-SHA256 (RFC 5869), 64-byte output — matches the Python client's HKDF call
static bool hkdf64(const unsigned char ikm[32], const std::string& salt,
                   const std::string& info, unsigned char out[64]) {
  unsigned char prk[32];
  unsigned int prk_len = 32;
  if (!hmac_fn(sha256_md(), salt.data(), (int)salt.size(), ikm, 32, prk, &prk_len)) return false;
  std::string t1_input = info + '\x01';
  unsigned int block_len = 32;
  if (!hmac_fn(sha256_md(), prk, 32, (const unsigned char*)t1_input.data(), t1_input.size(),
               out, &block_len))
    return false;
  std::string t2_input((char*)out, 32);
  t2_input += info;
  t2_input += '\x02';
  if (!hmac_fn(sha256_md(), prk, 32, (const unsigned char*)t2_input.data(), t2_input.size(),
               out + 32, &block_len))
    return false;
  return true;
}

// ChaCha20-Poly1305 seal/open; nonce = 4 zero bytes + LE64 counter, tag appended
static bool aead_seal(const unsigned char key[32], uint64_t counter,
                      const std::string& plaintext, std::string& out) {
  unsigned char nonce[12] = {0};
  memcpy(nonce + 4, &counter, 8);  // little-endian on all supported targets
  EVP_CIPHER_CTX* ctx = cipher_ctx_new();
  if (!ctx) return false;
  out.resize(plaintext.size() + 16);
  int len = 0, total = 0;
  bool ok = encrypt_init(ctx, chacha20_poly1305(), nullptr, key, nonce) == 1;
  if (ok && !plaintext.empty()) {
    ok = encrypt_update(ctx, (unsigned char*)&out[0], &len,
                        (const unsigned char*)plaintext.data(), (int)plaintext.size()) == 1;
    total = len;
  }
  ok = ok && encrypt_final(ctx, (unsigned char*)&out[0] + total, &len) == 1;
  total += len;
  ok = ok && cipher_ctx_ctrl(ctx, CTRL_AEAD_GET_TAG, 16, &out[total]) == 1;
  cipher_ctx_free(ctx);
  if (!ok) return false;
  out.resize(total + 16);
  return true;
}

static bool aead_open(const unsigned char key[32], uint64_t counter,
                      const std::string& ciphertext, std::string& out) {
  if (ciphertext.size() < 16) return false;
  unsigned char nonce[12] = {0};
  memcpy(nonce + 4, &counter, 8);
  EVP_CIPHER_CTX* ctx = cipher_ctx_new();
  if (!ctx) return false;
  size_t body = ciphertext.size() - 16;
  out.resize(body);
  int len = 0, total = 0;
  bool ok = decrypt_init(ctx, chacha20_poly1305(), nullptr, key, nonce) == 1;
  ok = ok && cipher_ctx_ctrl(ctx, CTRL_AEAD_SET_TAG, 16, (void*)(ciphertext.data() + body)) == 1;
  if (ok && body) {
    ok = decrypt_update(ctx, (unsigned char*)&out[0], &len, (const unsigned char*)ciphertext.data(),
                        (int)body) == 1;
    total = len;
  }
  unsigned char scratch[16];  // AEAD final emits no bytes; it only checks the tag
  len = 0;
  ok = ok && decrypt_final(ctx, scratch, &len) == 1;
  cipher_ctx_free(ctx);
  if (!ok) return false;
  out.resize(total + len);
  return true;
}
}  // namespace relay_crypto

static bool fill_random(unsigned char* buf, size_t len) {
  // getrandom(2): no fd, so an attacker holding connections open (EMFILE) cannot
  // starve challenge generation the way an open("/dev/urandom") path could
  size_t have = 0;
  while (have < len) {
    ssize_t n = getrandom(buf + have, len - have, 0);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    have += (size_t)n;
  }
  return true;
}

enum class ConnState {
  ReadingFrame, Control, SplicedWaiting, Spliced, Closed,
  // local data-plane proxy ('X'): the daemon terminates the peer's AEAD, so the
  // Python event loop ships PLAINTEXT frames over loopback and the native side
  // does the ChaCha20-Poly1305 seal/open + wire IO (reference role parity: the
  // entire transport lives in the Go daemon, hivemind/p2p/p2p_daemon.py:84-147)
  ProxyLocalWait,   // local conn: 'X' accepted, outbound connect in flight
  ProxyConnecting,  // outbound conn: awaiting connect() completion
  ProxyLocal,       // local side of an established proxy pair (plaintext frames)
  ProxyRemote,      // remote side (wire AEAD frames; holds the pair's keys)
  // inbound listen-proxy ('Y'): the daemon owns the PUBLIC listener and pairs
  // each accepted wire conn with a fresh loopback conn to the Python server —
  // the same ProxyLocal/ProxyRemote frame machine then runs with the roles
  // produced by the responder-side handshake (hello #1, 'K' #2, sealed #3+)
  InboundRemoteWait,       // accepted wire conn: local leg still connecting
  InboundLocalConnecting,  // daemon->server loopback conn: awaiting connect()
};

static constexpr size_t MAX_PROXY_FRAME = (16u << 20) + 16;  // crypto_channel MAX_FRAME_SIZE + tag

struct Conn {
  int fd = -1;
  ConnState state = ConnState::ReadingFrame;
  std::string inbuf;        // frame assembly
  std::string outbuf;       // pending writes
  std::string peer_id;      // set for control lines
  std::string pending_peer_id;  // REGISTER received, awaiting Ed25519 proof
  std::string challenge;        // 32B nonce the proof must sign
  std::string token;        // set for pending dial/accept conns
  // encrypted control channel ('H' handshake): per-direction ChaCha20-Poly1305
  bool enc = false;
  unsigned char send_key[32] = {0}, recv_key[32] = {0};
  uint64_t send_ctr = 0, recv_ctr = 0;
  // proxy pair ('X'): key material lives on the ProxyRemote conn (send = seal
  // local->wire, recv = open wire->local); distinct from `enc` so queue_frame's
  // control sealing can never alias the data-plane keys
  uint64_t proxy_frames = 0;  // parsed frames in this direction (1 = raw hello)
  bool proxy_keys = false;
  int peer_fd = -1;         // spliced counterpart
  double created_ms = 0;
  bool want_write = false;
  bool read_paused = false;  // EPOLLIN interest dropped (partner over HIGH_WATER)
  bool closing_after_flush = false;  // partner gone: close once outbuf drains
  std::vector<int> owned_listeners;  // 'Y' listeners tied to this control conn
};

static int g_epoll = -1;
static relay_crypto::EVP_PKEY* g_relay_identity = nullptr;  // Ed25519, fresh per run
static unsigned char g_relay_pub[32] = {0};
static std::map<int, Conn*> g_conns;
static std::map<std::string, int> g_control;        // peer_id -> control fd
static std::map<std::string, int> g_pending_dials;  // token -> dialer fd
static std::map<int, uint16_t> g_inbound_listeners;  // 'Y' listener fd -> local port

static void set_nonblock(int fd) {
  int flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
}

static bool is_local_client(int fd) {
  // the proxy control surface ('X'/'Y' and the 'K' key handoff) is local-only:
  // AF_UNIX peers are local by construction; AF_INET peers must be loopback.
  // (sockaddr_storage, NOT sockaddr_in: reading sin_addr from an AF_UNIX peer
  // yields path bytes and mis-classifies every unix client.)
  sockaddr_storage src{};
  socklen_t slen = sizeof(src);
  if (getpeername(fd, (sockaddr*)&src, &slen) != 0) return false;
  if (src.ss_family == AF_UNIX) return true;
  if (src.ss_family == AF_INET)
    return (ntohl(((sockaddr_in*)&src)->sin_addr.s_addr) >> 24) == 127;
  return false;
}

static void update_events(Conn* c) {
  epoll_event ev{};
  ev.events = (c->read_paused ? 0 : EPOLLIN) | (c->want_write ? EPOLLOUT : 0);
  ev.data.fd = c->fd;
  epoll_ctl(g_epoll, EPOLL_CTL_MOD, c->fd, &ev);
}

static void close_conn(int fd);

static void queue_write(Conn* c, const char* data, size_t len) {
  c->outbuf.append(data, len);
  if (!c->want_write) {
    c->want_write = true;
    update_events(c);
  }
}

static void queue_frame(Conn* c, const std::string& payload) {
  std::string body = payload;
  if (c->enc) {
    std::string sealed;
    if (!relay_crypto::aead_seal(c->send_key, c->send_ctr++, payload, sealed)) {
      close_conn(c->fd);
      return;
    }
    body.swap(sealed);
  }
  uint32_t n = htonl((uint32_t)body.size());
  std::string frame((char*)&n, 4);
  frame += body;
  queue_write(c, frame.data(), frame.size());
}

static void close_conn(int fd) {
  auto it = g_conns.find(fd);
  if (it == g_conns.end()) return;
  Conn* c = it->second;
  for (int lfd : c->owned_listeners) {
    // 'Y' listener lifetime is its owner control conn's: a dead server must not
    // leave the daemon accepting wire conns nobody will answer
    g_inbound_listeners.erase(lfd);
    epoll_ctl(g_epoll, EPOLL_CTL_DEL, lfd, nullptr);
    close(lfd);
  }
  if (!c->peer_id.empty()) {
    auto reg = g_control.find(c->peer_id);
    if (reg != g_control.end() && reg->second == fd) g_control.erase(reg);
  }
  if (!c->token.empty()) {
    auto pend = g_pending_dials.find(c->token);
    if (pend != g_pending_dials.end() && pend->second == fd) g_pending_dials.erase(pend);
  }
  int partner = c->peer_fd;
  epoll_ctl(g_epoll, EPOLL_CTL_DEL, fd, nullptr);
  close(fd);
  g_conns.erase(it);
  delete c;
  if (partner >= 0) {
    auto pit = g_conns.find(partner);
    if (pit != g_conns.end()) {
      Conn* p = pit->second;
      p->peer_fd = -1;
      if (p->outbuf.empty()) {
        close_conn(partner);  // pipe is bidirectional: one side gone, tear down both
      } else {
        // in-flight bytes the peer already sent must not be discarded: stop
        // reading, flush the tail, then close from on_writable (the periodic
        // sweep reaps flushers whose receiver never drains)
        p->closing_after_flush = true;
        p->read_paused = true;
        p->created_ms = now_ms();
        update_events(p);
      }
    }
  }
}

static void enable_keepalive(int fd) {
  int ka = 1, idle = 30, intvl = 10, cnt = 3;
  setsockopt(fd, SOL_SOCKET, SO_KEEPALIVE, &ka, sizeof(ka));
  setsockopt(fd, IPPROTO_TCP, TCP_KEEPIDLE, &idle, sizeof(idle));
  setsockopt(fd, IPPROTO_TCP, TCP_KEEPINTVL, &intvl, sizeof(intvl));
  setsockopt(fd, IPPROTO_TCP, TCP_KEEPCNT, &cnt, sizeof(cnt));
}

static void splice_pair(Conn* a, Conn* b) {
  a->peer_fd = b->fd;
  b->peer_fd = a->fd;
  a->state = b->state = ConnState::Spliced;
  enable_keepalive(a->fd);
  enable_keepalive(b->fd);
  // 'O' goes out under whatever framing each side negotiated; after it, both
  // sockets are a raw byte pipe (the peers' own end-to-end Noise takes over).
  // queue_frame can close a conn on an AEAD-seal failure — re-check liveness
  // before touching either side again (close_conn also tears down the partner).
  int a_fd = a->fd, b_fd = b->fd;
  queue_frame(a, "O");
  if (g_conns.find(a_fd) == g_conns.end()) return;
  queue_frame(b, "O");
  if (g_conns.find(b_fd) == g_conns.end()) return;
  a->enc = b->enc = false;
  // any bytes that raced ahead of the match are forwarded
  if (!a->inbuf.empty()) { queue_write(b, a->inbuf.data(), a->inbuf.size()); a->inbuf.clear(); }
  if (!b->inbuf.empty()) { queue_write(a, b->inbuf.data(), b->inbuf.size()); b->inbuf.clear(); }
}

static void refuse_and_close(Conn* c) {
  // 'E' then close — but through the flush path, or the refusal frame would be
  // discarded with the fd (close_conn does not drain outbuf)
  queue_frame(c, "E");
  c->closing_after_flush = true;
  c->read_paused = true;
  c->created_ms = now_ms();
  update_events(c);
}

static void forward_frame(Conn* partner, const std::string& payload) {
  uint32_t be = htonl((uint32_t)payload.size());
  std::string frame((char*)&be, 4);
  frame += payload;
  queue_write(partner, frame.data(), frame.size());
}

static bool proxy_process(Conn* c) {
  // Parse frames buffered on one side of a proxy pair; returns false when `c`
  // was closed. Frame protocol per direction (fixed by the Python handshake):
  //   local  #1 = plaintext hello (forward raw)   #2 = 'K' key install (consume)
  //          #3+ = plaintext payloads (seal toward the wire)
  //   remote #1 = plaintext hello (forward raw)   #2+ = AEAD ciphertext (open);
  //          held unparsed until the keys arrive — race-free by construction
  auto pit = g_conns.find(c->peer_fd);
  if (pit == g_conns.end()) { close_conn(c->fd); return false; }
  Conn* partner = pit->second;
  Conn* remote = (c->state == ConnState::ProxyRemote) ? c : partner;
  while (c->inbuf.size() >= 4) {
    uint32_t len = ntohl(*(uint32_t*)c->inbuf.data());
    if (len > MAX_PROXY_FRAME) { close_conn(c->fd); return false; }
    if (c->inbuf.size() < 4 + (size_t)len) break;
    if (c->state == ConnState::ProxyRemote && c->proxy_frames >= 1 && !c->proxy_keys)
      break;  // ciphertext before the local 'K': hold (bounded by the flood cap)
    std::string payload = c->inbuf.substr(4, len);
    c->inbuf.erase(0, 4 + len);
    c->proxy_frames++;
    if (c->proxy_frames == 1) {  // the handshake hello crosses unmodified
      forward_frame(partner, payload);
      continue;
    }
    if (c->state == ConnState::ProxyLocal) {
      if (c->proxy_frames == 2) {  // 'K' + send_key + recv_key + LE64 ctr x2
        if (payload.size() != 1 + 32 + 32 + 8 + 8 || payload[0] != 'K' ||
            !relay_crypto::channel_available) {
          close_conn(c->fd);
          return false;
        }
        memcpy(remote->send_key, payload.data() + 1, 32);
        memcpy(remote->recv_key, payload.data() + 33, 32);
        memcpy(&remote->send_ctr, payload.data() + 65, 8);
        memcpy(&remote->recv_ctr, payload.data() + 73, 8);
        remote->proxy_keys = true;
        // wire frames that arrived before the keys can drain now; a dead remote
        // makes the pair useless, so tear down both sides
        if (remote != c && !remote->inbuf.empty()) {
          int self_fd = c->fd;
          if (!proxy_process(remote)) {
            if (g_conns.find(self_fd) != g_conns.end()) close_conn(self_fd);
            return false;
          }
        }
        continue;
      }
      std::string sealed;
      if (!remote->proxy_keys ||
          !relay_crypto::aead_seal(remote->send_key, remote->send_ctr++, payload, sealed)) {
        close_conn(c->fd);
        return false;
      }
      forward_frame(partner, sealed);
    } else {  // ProxyRemote: open wire ciphertext, forward plaintext to local
      std::string opened;
      if (!relay_crypto::aead_open(c->recv_key, c->recv_ctr++, payload, opened)) {
        close_conn(c->fd);  // tampered/desynced frame is fatal to the pair
        return false;
      }
      forward_frame(partner, opened);
    }
  }
  return true;
}

static void handle_control_frame(Conn* c, const std::string& payload) {
  if (payload.empty()) { close_conn(c->fd); return; }
  char kind = payload[0];
  if (kind == 'H') {
    // Channel handshake: 'H' + client X25519 ephemeral(32) ->
    // 'S' + relay ephemeral(32) + relay Ed25519 pub(32) + sig(64) over
    // "hivemind-relay-hs:" + client_eph + relay_eph. All later frames on this
    // conn are ChaCha20-Poly1305 sealed (keys = HKDF-SHA256 of the ECDH secret),
    // so INCOMING tokens and registration proofs are opaque to on-path observers,
    // and pinning the relay pub on the client defeats a proxying relay.
    if (c->enc || !relay_crypto::channel_available || g_relay_identity == nullptr ||
        payload.size() != 1 + 32) {
      refuse_and_close(c);
      return;
    }
    relay_crypto::EVP_PKEY* eph = relay_crypto::generate_key(relay_crypto::EVP_PKEY_X25519);
    unsigned char eph_pub[32], shared[32], okm[64], sig[64];
    bool ok = eph != nullptr && relay_crypto::raw_public(eph, eph_pub) &&
              relay_crypto::x25519_shared(eph, (const unsigned char*)payload.data() + 1, shared);
    if (ok) {
      std::string transcript = "hivemind-relay-hs:" + payload.substr(1, 32) +
                               std::string((char*)eph_pub, 32);
      ok = relay_crypto::hkdf64(shared, "hivemind-relay-hs", "control", okm) &&
           relay_crypto::ed25519_sign(g_relay_identity, transcript, sig);
    }
    if (eph) relay_crypto::pkey_free(eph);
    if (!ok) { refuse_and_close(c); return; }
    std::string reply = "S" + std::string((char*)eph_pub, 32) +
                        std::string((char*)g_relay_pub, 32) + std::string((char*)sig, 64);
    queue_frame(c, reply);  // plaintext: the client derives keys from this reply
    memcpy(c->recv_key, okm, 32);       // client -> relay
    memcpy(c->send_key, okm + 32, 32);  // relay -> client
    c->send_ctr = c->recv_ctr = 0;
    c->enc = true;
  } else if (kind == 'R') {
    std::string peer_id = payload.substr(1);
    if (peer_id.empty()) { close_conn(c->fd); return; }
    if (relay_crypto::available) {
      // Challenge-response registration: a peer_id is sha2-256 multihash
      // (0x12 0x20 + 32B digest of the Ed25519 pubkey), so ownership is provable.
      if (peer_id.size() != 34 || peer_id[0] != 0x12 || (unsigned char)peer_id[1] != 0x20) {
        refuse_and_close(c);
        return;
      }
      unsigned char nonce[32];
      if (!fill_random(nonce, sizeof(nonce))) { refuse_and_close(c); return; }
      c->pending_peer_id = peer_id;
      c->challenge.assign((char*)nonce, sizeof(nonce));
      queue_frame(c, std::string("C") + c->challenge);
      return;
    }
    // Legacy (no libcrypto): first registration wins — a later REGISTER for the
    // same peer_id is REFUSED while the original control line is alive, so an
    // attacker cannot evict a registered peer and capture its INCOMING
    // notifications; dead lines are reaped by TCP keepalive + EPOLLHUP.
    auto old = g_control.find(peer_id);
    if (old != g_control.end() && old->second != c->fd) {
      queue_frame(c, "E");
      return;
    }
    // re-registering a different id on the same line must not leave a dangling
    // g_control entry pointing at this fd (a later DIAL would deref a stale conn)
    if (!c->peer_id.empty() && c->peer_id != peer_id) g_control.erase(c->peer_id);
    c->peer_id = peer_id;
    g_control[c->peer_id] = c->fd;
    c->state = ConnState::Control;
    enable_keepalive(c->fd);
    queue_frame(c, "O");
  } else if (kind == 'P') {
    // PROOF: 'P' + 32B raw Ed25519 pubkey + 64B signature over
    // "hivemind-relay-register:" + challenge + peer_id
    if (c->pending_peer_id.empty() || payload.size() != 1 + 32 + 64) {
      refuse_and_close(c);
      return;
    }
    std::string pubkey = payload.substr(1, 32);
    std::string signature = payload.substr(33, 64);
    unsigned char digest[32];
    bool id_matches = relay_crypto::sha256(pubkey, digest) &&
                      memcmp(digest, c->pending_peer_id.data() + 2, 32) == 0;
    std::string message = "hivemind-relay-register:" + c->challenge + c->pending_peer_id;
    if (!id_matches || !relay_crypto::ed25519_verify(pubkey, message, signature)) {
      refuse_and_close(c);
      return;
    }
    // proven owner: evict any stale control line for this id (only the key holder
    // reaches this point, so this is reclamation, not hijack)
    auto old = g_control.find(c->pending_peer_id);
    if (old != g_control.end() && old->second != c->fd) close_conn(old->second);
    if (!c->peer_id.empty() && c->peer_id != c->pending_peer_id) g_control.erase(c->peer_id);
    c->peer_id = c->pending_peer_id;
    c->pending_peer_id.clear();
    c->challenge.clear();
    g_control[c->peer_id] = c->fd;
    c->state = ConnState::Control;
    enable_keepalive(c->fd);
    queue_frame(c, "O");
  } else if (kind == 'D' && payload.size() > 17) {
    std::string token = payload.substr(1, 16);
    std::string target = payload.substr(17);
    auto reg = g_control.find(target);
    auto target_conn = reg == g_control.end() ? g_conns.end() : g_conns.find(reg->second);
    if (target_conn == g_conns.end()) { refuse_and_close(c); return; }
    c->token = token;
    c->state = ConnState::SplicedWaiting;
    g_pending_dials[token] = c->fd;
    c->created_ms = now_ms();
    queue_frame(target_conn->second, std::string("I") + token);
  } else if (kind == 'X' && payload.size() >= 4) {
    // PROXY-CONNECT: 'X' + u16 BE port + ip — open an outbound data-plane
    // connection; reply 'O' once connected, then frame-forward with AEAD
    // termination (see proxy_process). Requires libcrypto (the whole point is
    // native seal/open). STRICTLY LOOPBACK-ONLY: this is a local data-plane
    // offload for co-resident peers — honoring it from a remote client would
    // turn every public relay into an open TCP proxy / SSRF vector.
    if (!is_local_client(c->fd) || c->peer_fd >= 0 || c->enc ||
        !relay_crypto::channel_available) {
      refuse_and_close(c);
      return;
    }
    uint16_t port = ((uint8_t)payload[1] << 8) | (uint8_t)payload[2];
    std::string host = payload.substr(3);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    if (inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) { refuse_and_close(c); return; }
    int rfd = socket(AF_INET, SOCK_STREAM, 0);
    if (rfd < 0) { refuse_and_close(c); return; }
    set_nonblock(rfd);
    int rc = connect(rfd, (sockaddr*)&addr, sizeof(addr));
    if (rc < 0 && errno != EINPROGRESS) { close(rfd); refuse_and_close(c); return; }
    Conn* r = new Conn();
    r->fd = rfd;
    r->state = ConnState::ProxyConnecting;
    r->created_ms = now_ms();
    r->peer_fd = c->fd;
    r->want_write = true;
    g_conns[rfd] = r;
    epoll_event rev{};
    rev.events = EPOLLOUT;
    rev.data.fd = rfd;
    epoll_ctl(g_epoll, EPOLL_CTL_ADD, rfd, &rev);
    c->peer_fd = rfd;
    c->state = ConnState::ProxyLocalWait;
    c->created_ms = now_ms();
  } else if (kind == 'Y' && payload.size() == 5) {
    // inbound listen-proxy registration: 'Y' <u16 BE public_port> <u16 BE
    // local_port> from a LOCAL server process. The daemon binds public_port
    // (0 = ephemeral), replies 'O' <u16 BE actual_port>, and forwards every
    // accepted wire conn to 127.0.0.1:local_port as a ProxyRemote/ProxyLocal
    // pair — the server's AEAD then terminates HERE for both directions. The
    // listener dies with this control conn.
    if (!is_local_client(c->fd) || !relay_crypto::channel_available) {
      refuse_and_close(c);
      return;
    }
    uint16_t public_port = ((uint8_t)payload[1] << 8) | (uint8_t)payload[2];
    uint16_t local_port = ((uint8_t)payload[3] << 8) | (uint8_t)payload[4];
    int lfd = socket(AF_INET, SOCK_STREAM, 0);
    if (lfd < 0) { refuse_and_close(c); return; }
    int one = 1;
    setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in baddr{};
    baddr.sin_family = AF_INET;
    baddr.sin_addr.s_addr = INADDR_ANY;
    baddr.sin_port = htons(public_port);
    if (bind(lfd, (sockaddr*)&baddr, sizeof(baddr)) < 0 || listen(lfd, 128) < 0) {
      close(lfd);
      refuse_and_close(c);
      return;
    }
    set_nonblock(lfd);
    socklen_t blen = sizeof(baddr);
    getsockname(lfd, (sockaddr*)&baddr, &blen);
    g_inbound_listeners[lfd] = local_port;
    c->owned_listeners.push_back(lfd);
    epoll_event lev{};
    lev.events = EPOLLIN;
    lev.data.fd = lfd;
    epoll_ctl(g_epoll, EPOLL_CTL_ADD, lfd, &lev);
    uint16_t actual = ntohs(baddr.sin_port);
    char reply[3] = {'O', (char)(actual >> 8), (char)(actual & 0xff)};
    queue_frame(c, std::string(reply, 3));
  } else if (kind == 'W') {
    sockaddr_in observed{};
    socklen_t olen = sizeof(observed);
    if (getpeername(c->fd, (sockaddr*)&observed, &olen) == 0) {
      char ip[INET_ADDRSTRLEN];
      inet_ntop(AF_INET, &observed.sin_addr, ip, sizeof(ip));
      char reply[64];
      int n = snprintf(reply, sizeof(reply), "O%s:%d", ip, ntohs(observed.sin_port));
      queue_frame(c, std::string(reply, n));
    } else {
      queue_frame(c, "E");
    }
  } else if (kind == 'A' && payload.size() >= 17) {
    std::string token = payload.substr(1, 16);
    auto pend = g_pending_dials.find(token);
    auto dialer_it = pend == g_pending_dials.end() ? g_conns.end() : g_conns.find(pend->second);
    if (dialer_it == g_conns.end()) { refuse_and_close(c); return; }
    Conn* dialer = dialer_it->second;
    g_pending_dials.erase(pend);
    dialer->token.clear();
    splice_pair(dialer, c);
  } else {
    close_conn(c->fd);
  }
}

static void on_readable(Conn* c) {
  char buf[SPLICE_BUF];
  while (true) {
    ssize_t n = read(c->fd, buf, sizeof(buf));
    if (n == 0) { close_conn(c->fd); return; }
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      close_conn(c->fd); return;
    }
    if (c->state == ConnState::Spliced) {
      auto pit = g_conns.find(c->peer_fd);
      if (pit == g_conns.end()) { close_conn(c->fd); return; }
      queue_write(pit->second, buf, n);
      if (pit->second->outbuf.size() > HIGH_WATER) {
        // real backpressure: drop EPOLLIN interest until the partner drains
        c->read_paused = true;
        update_events(c);
        break;
      }
    } else if (c->state == ConnState::ProxyLocal || c->state == ConnState::ProxyRemote) {
      c->inbuf.append(buf, n);
      // pre-key flood bound: a remote shipping ciphertext before the local 'K'
      // may buffer at most one max frame + slack
      if (c->inbuf.size() > MAX_PROXY_FRAME + (1u << 20)) { close_conn(c->fd); return; }
      if (!proxy_process(c)) return;
      auto pit = g_conns.find(c->peer_fd);
      if (pit != g_conns.end() && pit->second->outbuf.size() > HIGH_WATER) {
        c->read_paused = true;
        update_events(c);
        break;
      }
    } else if (c->state == ConnState::ProxyLocalWait ||
               c->state == ConnState::InboundRemoteWait) {
      // partner leg still connecting: buffer ('X' local: at most an eager
      // hello; 'Y' wire: the initiator hello plus possibly its sealed confirm)
      c->inbuf.append(buf, n);
      if (c->inbuf.size() > MAX_PROXY_FRAME + (1u << 20)) { close_conn(c->fd); return; }
    } else {
      c->inbuf.append(buf, n);
      while (c->state != ConnState::Spliced && c->inbuf.size() >= 4) {
        uint32_t len = ntohl(*(uint32_t*)c->inbuf.data());
        if (len > MAX_FRAME) { close_conn(c->fd); return; }
        if (c->inbuf.size() < 4 + len) break;
        std::string payload = c->inbuf.substr(4, len);
        c->inbuf.erase(0, 4 + len);
        if (c->enc) {
          std::string opened;
          if (!relay_crypto::aead_open(c->recv_key, c->recv_ctr++, payload, opened)) {
            close_conn(c->fd);  // tampered/replayed frame: drop the connection
            return;
          }
          payload.swap(opened);
        }
        handle_control_frame(c, payload);
        if (g_conns.find(c->fd) == g_conns.end()) return;  // frame handler closed us
        if (c->closing_after_flush) return;  // refused: flush 'E', ignore further input
      }
    }
  }
}

static void maybe_resume_partner(Conn* c) {
  // our queue drained below LOW_WATER: re-arm the peer that was paused on us
  if (c->outbuf.size() >= LOW_WATER || c->peer_fd < 0) return;
  auto pit = g_conns.find(c->peer_fd);
  if (pit != g_conns.end() && pit->second->read_paused) {
    pit->second->read_paused = false;
    update_events(pit->second);
  }
}

static void on_writable(Conn* c) {
  if (c->state == ConnState::InboundLocalConnecting) {
    // daemon->server loopback leg of a 'Y' pair landed: the accepted wire conn
    // becomes ProxyRemote (its buffered initiator hello/ciphertext drains
    // through the shared frame machine) and this conn carries plaintext
    int err = 0;
    socklen_t elen = sizeof(err);
    getsockopt(c->fd, SOL_SOCKET, SO_ERROR, &err, &elen);
    auto pit = g_conns.find(c->peer_fd);
    if (err != 0 || pit == g_conns.end()) { close_conn(c->fd); return; }
    c->state = ConnState::ProxyLocal;
    c->want_write = false;
    int one = 1;
    setsockopt(c->fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    enable_keepalive(c->fd);
    update_events(c);
    Conn* wire = pit->second;
    wire->state = ConnState::ProxyRemote;
    enable_keepalive(wire->fd);
    if (!wire->inbuf.empty()) proxy_process(wire);
    return;
  }
  if (c->state == ConnState::ProxyConnecting) {
    int err = 0;
    socklen_t elen = sizeof(err);
    getsockopt(c->fd, SOL_SOCKET, SO_ERROR, &err, &elen);
    auto pit = g_conns.find(c->peer_fd);
    if (err != 0 || pit == g_conns.end()) { close_conn(c->fd); return; }
    c->state = ConnState::ProxyRemote;
    c->want_write = false;
    int one = 1;
    setsockopt(c->fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    enable_keepalive(c->fd);
    update_events(c);
    Conn* local = pit->second;
    local->state = ConnState::ProxyLocal;
    enable_keepalive(local->fd);
    queue_frame(local, "O");
    if (!local->inbuf.empty()) proxy_process(local);  // an eager hello was buffered
    return;
  }
  while (!c->outbuf.empty()) {
    ssize_t n = write(c->fd, c->outbuf.data(), c->outbuf.size());
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) { maybe_resume_partner(c); return; }
      close_conn(c->fd); return;
    }
    c->outbuf.erase(0, n);
  }
  if (c->closing_after_flush) { close_conn(c->fd); return; }
  c->want_write = false;
  update_events(c);
  maybe_resume_partner(c);
}

int main(int argc, char** argv) {
  int port = argc > 1 ? atoi(argv[1]) : 34000;
  signal(SIGPIPE, SIG_IGN);
  relay_crypto::available = relay_crypto::load();
  if (!relay_crypto::available)
    fprintf(stderr, "relay: libcrypto unavailable, registrations are UNAUTHENTICATED\n");
  if (relay_crypto::channel_available) {
    const char* identity_path = argc > 2 && argv[2][0] != '\0' ? argv[2] : nullptr;
    if (identity_path != nullptr) {
      // persistent identity so client pins survive daemon restarts
      FILE* f = fopen(identity_path, "rb");
      if (f != nullptr) {
        unsigned char raw[32];
        if (fread(raw, 1, 32, f) == 32)
          g_relay_identity = relay_crypto::new_raw_private_key(
              relay_crypto::EVP_PKEY_ED25519, nullptr, raw, 32);
        fclose(f);
      }
    }
    if (g_relay_identity == nullptr) {
      g_relay_identity = relay_crypto::generate_key(relay_crypto::EVP_PKEY_ED25519);
      if (g_relay_identity != nullptr && identity_path != nullptr) {
        unsigned char raw[32];
        size_t raw_len = 32;
        int fd = open(identity_path, O_WRONLY | O_CREAT | O_TRUNC, 0600);
        if (fd >= 0 &&
            relay_crypto::get_raw_private_key(g_relay_identity, raw, &raw_len) == 1 &&
            raw_len == 32) {
          if (write(fd, raw, 32) != 32)
            fprintf(stderr, "relay: could not persist identity to %s\n", identity_path);
        }
        if (fd >= 0) close(fd);
      }
    }
    if (g_relay_identity != nullptr && !relay_crypto::raw_public(g_relay_identity, g_relay_pub)) {
      g_relay_identity = nullptr;
      fprintf(stderr, "relay: identity keygen failed, encrypted control disabled\n");
    }
  }

  int listener = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(listener, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  // argv[4]: optional TCP bind address. A PRIVATE daemon (spawned for one
  // process with a unix control socket) binds 127.0.0.1 so it exposes no
  // remote relay surface; public relay deployments keep the INADDR_ANY default.
  const char* bind_host = argc > 4 && argv[4][0] != '\0' ? argv[4] : nullptr;
  if (bind_host != nullptr && inet_pton(AF_INET, bind_host, &addr.sin_addr) != 1) {
    fprintf(stderr, "relay: invalid bind address %s\n", bind_host);
    return 1;
  }
  addr.sin_port = htons((uint16_t)port);
  if (bind(listener, (sockaddr*)&addr, sizeof(addr)) < 0) { perror("bind"); return 1; }
  if (listen(listener, 128) < 0) { perror("listen"); return 1; }
  set_nonblock(listener);

  // optional same-user-only AF_UNIX listener (see usage comment): the socket
  // file is created 0600, so the kernel enforces that only this user's
  // processes can reach the 'K' key-handoff path
  int unix_listener = -1;
  const char* unix_path = argc > 3 && argv[3][0] != '\0' ? argv[3] : nullptr;
  if (unix_path != nullptr) {
    unix_listener = socket(AF_UNIX, SOCK_STREAM, 0);
    sockaddr_un uaddr{};
    uaddr.sun_family = AF_UNIX;
    if (strlen(unix_path) >= sizeof(uaddr.sun_path)) {
      fprintf(stderr, "relay: unix socket path too long: %s\n", unix_path);
      return 1;
    }
    strncpy(uaddr.sun_path, unix_path, sizeof(uaddr.sun_path) - 1);
    unlink(unix_path);
    mode_t old_umask = umask(0177);
    int rc = bind(unix_listener, (sockaddr*)&uaddr, sizeof(uaddr));
    umask(old_umask);
    if (rc < 0) { perror("unix bind"); return 1; }
    if (listen(unix_listener, 128) < 0) { perror("unix listen"); return 1; }
    set_nonblock(unix_listener);
  }

  socklen_t alen = sizeof(addr);
  getsockname(listener, (sockaddr*)&addr, &alen);
  printf("relay listening on port %d\n", ntohs(addr.sin_port));
  if (g_relay_identity != nullptr) {
    char hex[65];
    for (int i = 0; i < 32; i++) snprintf(hex + 2 * i, 3, "%02x", g_relay_pub[i]);
    printf("relay identity %s\n", hex);
  } else {
    // exactly two startup lines in EVERY build, emitted in one flush: launchers
    // can block-read both instead of racing a buffered stream with select()
    printf("relay encryption unavailable\n");
  }
  fflush(stdout);

  g_epoll = epoll_create1(0);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = listener;
  epoll_ctl(g_epoll, EPOLL_CTL_ADD, listener, &ev);
  if (unix_listener >= 0) {
    epoll_event uev{};
    uev.events = EPOLLIN;
    uev.data.fd = unix_listener;
    epoll_ctl(g_epoll, EPOLL_CTL_ADD, unix_listener, &uev);
  }

  std::vector<epoll_event> events(256);
  double last_sweep = now_ms();
  while (true) {
    int n = epoll_wait(g_epoll, events.data(), (int)events.size(), 1000);
    for (int i = 0; i < n; i++) {
      int fd = events[i].data.fd;
      if (fd == listener || (unix_listener >= 0 && fd == unix_listener)) {
        while (true) {
          int client = accept(fd, nullptr, nullptr);
          if (client < 0) break;
          set_nonblock(client);
          // harmless no-op (ENOTSUP) on AF_UNIX clients
          setsockopt(client, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          Conn* c = new Conn();
          c->fd = client;
          c->created_ms = now_ms();
          g_conns[client] = c;
          epoll_event cev{};
          cev.events = EPOLLIN;
          cev.data.fd = client;
          epoll_ctl(g_epoll, EPOLL_CTL_ADD, client, &cev);
        }
        continue;
      }
      auto inbound_it = g_inbound_listeners.find(fd);
      if (inbound_it != g_inbound_listeners.end()) {
        // 'Y' public listener: pair every accepted wire conn with a fresh
        // loopback connect to the registered server port
        uint16_t local_port = inbound_it->second;
        while (true) {
          int wire = accept(fd, nullptr, nullptr);
          if (wire < 0) break;
          set_nonblock(wire);
          setsockopt(wire, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          sockaddr_in laddr{};
          laddr.sin_family = AF_INET;
          laddr.sin_port = htons(local_port);
          inet_pton(AF_INET, "127.0.0.1", &laddr.sin_addr);
          int local = socket(AF_INET, SOCK_STREAM, 0);
          bool ok = local >= 0;
          if (ok) {
            set_nonblock(local);
            int rc = connect(local, (sockaddr*)&laddr, sizeof(laddr));
            ok = rc == 0 || errno == EINPROGRESS;
          }
          if (!ok) {
            if (local >= 0) close(local);
            close(wire);
            continue;
          }
          Conn* r = new Conn();
          r->fd = wire;
          r->state = ConnState::InboundRemoteWait;
          r->created_ms = now_ms();
          r->peer_fd = local;
          g_conns[wire] = r;
          epoll_event wev{};
          wev.events = EPOLLIN;
          wev.data.fd = wire;
          epoll_ctl(g_epoll, EPOLL_CTL_ADD, wire, &wev);
          Conn* l = new Conn();
          l->fd = local;
          l->state = ConnState::InboundLocalConnecting;
          l->created_ms = now_ms();
          l->peer_fd = wire;
          l->want_write = true;
          g_conns[local] = l;
          epoll_event lev2{};
          lev2.events = EPOLLOUT;
          lev2.data.fd = local;
          epoll_ctl(g_epoll, EPOLL_CTL_ADD, local, &lev2);
        }
        continue;
      }
      auto it = g_conns.find(fd);
      if (it == g_conns.end()) continue;
      if (events[i].events & (EPOLLERR | EPOLLHUP)) { close_conn(fd); continue; }
      if (events[i].events & EPOLLIN) on_readable(it->second);
      if (g_conns.find(fd) == g_conns.end()) continue;
      if (events[i].events & EPOLLOUT) on_writable(it->second);
    }
    if (now_ms() - last_sweep > 5000) {  // expire unmatched dials + stuck flushers
      last_sweep = now_ms();
      std::vector<int> expired;
      for (auto& [token, fd] : g_pending_dials) {
        auto it = g_conns.find(fd);
        if (it == g_conns.end() || now_ms() - it->second->created_ms > PENDING_DIAL_TTL_MS)
          expired.push_back(fd);
      }
      for (auto& [fd, conn] : g_conns) {
        if (conn->closing_after_flush && now_ms() - conn->created_ms > FLUSH_TTL_MS)
          expired.push_back(fd);
        if ((conn->state == ConnState::ProxyConnecting || conn->state == ConnState::ProxyLocalWait
             || conn->state == ConnState::InboundRemoteWait
             || conn->state == ConnState::InboundLocalConnecting)
            && now_ms() - conn->created_ms > PENDING_DIAL_TTL_MS)
          expired.push_back(fd);
      }
      for (int fd : expired) close_conn(fd);
    }
  }
}
