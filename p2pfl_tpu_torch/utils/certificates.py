"""mTLS certificate tooling (the port's copy of
``p2pfl_tpu/utils/certificates.py``).

Capability parity with the reference's ``p2pfl/certificates/gen-certs.sh``
(+ openssl.cnf / server_ext.cnf / client_ext.cnf): a self-signed CA that
signs one server and one client certificate, suitable for the gRPC
transport's mutual-TLS mode (``Settings.USE_SSL`` — grpc_protocol.py server
creds require client auth). Implemented in Python over ``cryptography`` so
federations can mint ephemeral certs programmatically (tests, CI,
single-command deployments) instead of shelling out to openssl.

``cryptography`` is imported when certificates are minted, not when this
module is imported: machines without it still import the port.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
from typing import TYPE_CHECKING, Dict, Sequence

if TYPE_CHECKING:  # pragma: no cover
    from cryptography import x509
    from cryptography.hazmat.primitives.asymmetric import rsa


def _key() -> "rsa.RSAPrivateKey":
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _name(common_name: str) -> "x509.Name":
    from cryptography import x509
    from cryptography.x509.oid import NameOID

    return x509.Name(
        [
            x509.NameAttribute(NameOID.ORGANIZATION_NAME, "p2pfl_tpu"),
            x509.NameAttribute(NameOID.COMMON_NAME, common_name),
        ]
    )


def _san(hostnames: Sequence[str]) -> "x509.SubjectAlternativeName":
    from cryptography import x509

    alts: list[x509.GeneralName] = []
    for h in hostnames:
        try:
            alts.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            alts.append(x509.DNSName(h))
    return x509.SubjectAlternativeName(alts)


def _write_key(path: str, key: "rsa.RSAPrivateKey") -> None:
    from cryptography.hazmat.primitives import serialization

    with open(path, "wb") as f:
        f.write(
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.TraditionalOpenSSL,
                serialization.NoEncryption(),
            )
        )


def _write_cert(path: str, cert: "x509.Certificate") -> None:
    from cryptography.hazmat.primitives import serialization

    with open(path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))


def generate_certificates(
    out_dir: str,
    hostnames: Sequence[str] = ("localhost", "127.0.0.1", "::1"),
    days: int = 500,
) -> Dict[str, str]:
    """Mint a CA + CA-signed server and client certs (gen-certs.sh semantics).

    Returns a dict of paths keyed ``ca_crt, server_key, server_crt,
    client_key, client_crt`` — exactly the five ``Settings.SSL_*`` knobs the
    gRPC transport reads.
    """
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes

    os.makedirs(out_dir, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    not_after = now + datetime.timedelta(days=days)

    ca_key = _key()
    ca_name = _name("p2pfl_tpu-ca")
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name)
        .issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(not_after)
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        .sign(ca_key, hashes.SHA256())
    )

    def issue(common_name: str) -> "tuple[rsa.RSAPrivateKey, x509.Certificate]":
        key = _key()
        cert = (
            x509.CertificateBuilder()
            .subject_name(_name(common_name))
            .issuer_name(ca_name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(not_after)
            .add_extension(_san(hostnames), critical=False)
            .add_extension(
                x509.ExtendedKeyUsage(
                    [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH,
                     x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH]
                ),
                critical=False,
            )
            .sign(ca_key, hashes.SHA256())
        )
        return key, cert

    server_key, server_cert = issue("p2pfl_tpu-server")
    client_key, client_cert = issue("p2pfl_tpu-client")

    paths = {
        "ca_crt": os.path.join(out_dir, "ca.crt"),
        "server_key": os.path.join(out_dir, "server.key"),
        "server_crt": os.path.join(out_dir, "server.crt"),
        "client_key": os.path.join(out_dir, "client.key"),
        "client_crt": os.path.join(out_dir, "client.crt"),
    }
    _write_cert(paths["ca_crt"], ca_cert)
    _write_key(paths["server_key"], server_key)
    _write_cert(paths["server_crt"], server_cert)
    _write_key(paths["client_key"], client_key)
    _write_cert(paths["client_crt"], client_cert)
    return paths
