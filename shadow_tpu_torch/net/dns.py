"""DNS / addressing registry.

Reference: `src/main/routing/dns.c` (230 LoC — global name<->IP registry
with per-host hostname files) and `address.c`; lookups surface to managed
code via `shadow_hostname_to_addr_ipv4` (handler/mod.rs:513-517) and the
shim's addrinfo emulation (shim_api_addrinfo.c).
"""

from __future__ import annotations

import ipaddress


class DnsError(Exception):
    pass


class Dns:
    def __init__(self):
        self._by_name: dict[str, str] = {}
        self._by_ip: dict[str, str] = {}

    def register(self, name: str, ip: str):
        ipaddress.ip_address(ip)  # validates
        if name in self._by_name and self._by_name[name] != ip:
            raise DnsError(f"hostname {name!r} already registered")
        if ip in self._by_ip and self._by_ip[ip] != name:
            raise DnsError(f"address {ip} already registered to {self._by_ip[ip]!r}")
        self._by_name[name] = ip
        self._by_ip[ip] = name

    def resolve(self, name: str) -> str | None:
        """name (or dotted-quad literal) -> IP, like getaddrinfo."""
        if name in self._by_name:
            return self._by_name[name]
        try:
            return str(ipaddress.ip_address(name))
        except ValueError:
            return None

    def reverse(self, ip: str) -> str | None:
        return self._by_ip.get(ip)

    def hosts_file(self) -> str:
        """An /etc/hosts rendering (the reference writes per-host hostname
        files for managed processes)."""
        lines = ["127.0.0.1 localhost"]
        for name in sorted(self._by_name):
            lines.append(f"{self._by_name[name]} {name}")
        return "\n".join(lines) + "\n"

    def __len__(self) -> int:
        return len(self._by_name)
