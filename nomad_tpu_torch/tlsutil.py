"""TLS material + context construction for the RPC transport (behavioral
ref helper/tlsutil/config.go — server/client SSLContexts with mutual
verification — and the cert-generation side of `nomad tls` / test helpers).

Certificates follow the reference's naming scheme: servers present
``server.<region>.nomad``, clients ``client.<region>.nomad``, and peers
verify both the chain (shared CA) and, optionally, the role-and-region
name (``verify_server_hostname``)."""
from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
from dataclasses import dataclass, field
from typing import Optional


# ----------------------------------------------------------- cert generation

def _write(path: str, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    os.chmod(path, 0o600)
    return path


def generate_ca(out_dir: str, name: str = "nomad-tpu-ca"
                ) -> tuple[str, str]:
    """Self-signed CA. Returns (ca_cert_path, ca_key_path)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    subject = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(subject).issuer_name(subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=3650))
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .add_extension(x509.KeyUsage(
                digital_signature=True, key_cert_sign=True, crl_sign=True,
                content_commitment=False, key_encipherment=False,
                data_encipherment=False, key_agreement=False,
                encipher_only=False, decipher_only=False), critical=True)
            .sign(key, hashes.SHA256()))
    os.makedirs(out_dir, exist_ok=True)
    cert_path = _write(os.path.join(out_dir, "ca.pem"),
                       cert.public_bytes(serialization.Encoding.PEM))
    key_path = _write(
        os.path.join(out_dir, "ca-key.pem"),
        key.private_bytes(serialization.Encoding.PEM,
                          serialization.PrivateFormat.PKCS8,
                          serialization.NoEncryption()))
    return cert_path, key_path


def generate_cert(out_dir: str, ca_cert: str, ca_key: str, name: str,
                  extra_sans: Optional[list[str]] = None
                  ) -> tuple[str, str]:
    """CA-signed leaf cert for `name` (e.g. "server.global.nomad"), valid
    for both server and client auth (peers are both, as in the reference's
    mutual-TLS RPC). Returns (cert_path, key_path)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    with open(ca_cert, "rb") as f:
        ca = x509.load_pem_x509_certificate(f.read())
    with open(ca_key, "rb") as f:
        cakey = serialization.load_pem_private_key(f.read(), password=None)

    key = ec.generate_private_key(ec.SECP256R1())
    sans: list[x509.GeneralName] = [x509.DNSName(name),
                                    x509.DNSName("localhost")]
    for san in extra_sans or []:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(san)))
        except ValueError:
            sans.append(x509.DNSName(san))
    sans.append(x509.IPAddress(ipaddress.ip_address("127.0.0.1")))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(x509.Name(
                [x509.NameAttribute(NameOID.COMMON_NAME, name)]))
            .issuer_name(ca.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.SubjectAlternativeName(sans), critical=False)
            .add_extension(x509.ExtendedKeyUsage(
                [ExtendedKeyUsageOID.SERVER_AUTH,
                 ExtendedKeyUsageOID.CLIENT_AUTH]), critical=False)
            .sign(cakey, hashes.SHA256()))
    os.makedirs(out_dir, exist_ok=True)
    slug = name.split(".")[0]
    cert_path = _write(os.path.join(out_dir, f"{slug}.pem"),
                       cert.public_bytes(serialization.Encoding.PEM))
    key_path = _write(
        os.path.join(out_dir, f"{slug}-key.pem"),
        key.private_bytes(serialization.Encoding.PEM,
                          serialization.PrivateFormat.PKCS8,
                          serialization.NoEncryption()))
    return cert_path, key_path


# --------------------------------------------------------------- TLS config

@dataclass
class TLSConfig:
    """The `tls { }` agent stanza (ref nomad/structs/config/tls.go)."""
    enable_rpc: bool = False
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    # require the remote to present a cert signed by ca_file AND named
    # for its role+region (ref VerifyServerHostname)
    verify_server_hostname: bool = False
    region: str = "global"

    def server_context(self) -> ssl.SSLContext:
        """Context for the RPC listener: mutual TLS — clients must present
        a CA-signed cert (ref tlsutil IncomingTLSConfig w/
        VerifyIncomingRPC)."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(self.cert_file, self.key_file)
        ctx.load_verify_locations(self.ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def client_context(self) -> ssl.SSLContext:
        """Context for outbound RPC connections (ref OutgoingTLSConfig)."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_verify_locations(self.ca_file)
        ctx.load_cert_chain(self.cert_file, self.key_file)
        if not self.verify_server_hostname:
            ctx.check_hostname = False
        return ctx

    @property
    def server_name(self) -> str:
        """The name dialers verify when verify_server_hostname is set."""
        return f"server.{self.region or 'global'}.nomad"
