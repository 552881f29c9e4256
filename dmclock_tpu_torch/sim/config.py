"""Simulation configuration, INI-compatible with the reference (the
port's copy of ``dmclock_tpu/sim/config.py``).

Parses the same file format as the reference's config subsystem
(``sim/src/config.h:32-155``, ``config.cc:123-184``, Ceph-style
``ConfUtils`` INI underneath): a ``[global]`` section plus numbered
``[client.N]`` / ``[server.N]`` group sections.  Defaults equal the
reference struct-constructor defaults so a bare config behaves
identically.
"""

from __future__ import annotations

import configparser
from dataclasses import dataclass, field
from typing import List


@dataclass
class ClientGroup:
    """One [client.N] section (reference cli_group_t, config.h:32-84)."""

    client_count: int = 100
    client_wait_s: float = 0.0
    client_total_ops: int = 1000
    client_server_select_range: int = 10
    client_iops_goal: float = 50.0
    client_outstanding_ops: int = 100
    client_reservation: float = 20.0
    client_limit: float = 60.0
    client_weight: float = 1.0
    client_req_cost: int = 1


@dataclass
class ServerGroup:
    """One [server.N] section (reference srv_group_t, config.h:87-110)."""

    server_count: int = 100
    server_iops: float = 40.0
    server_threads: int = 1


@dataclass
class SimConfig:
    """Whole-simulation config (reference sim_config_t, config.h:113-149)."""

    server_groups: int = 1
    client_groups: int = 1
    server_random_selection: bool = False
    server_soft_limit: bool = True
    anticipation_timeout_s: float = 0.0
    cli_group: List[ClientGroup] = field(default_factory=list)
    srv_group: List[ServerGroup] = field(default_factory=list)

    def __post_init__(self) -> None:
        while len(self.cli_group) < self.client_groups:
            self.cli_group.append(ClientGroup())
        while len(self.srv_group) < self.server_groups:
            self.srv_group.append(ServerGroup())

    @property
    def total_clients(self) -> int:
        return sum(g.client_count for g in self.cli_group)

    @property
    def total_servers(self) -> int:
        return sum(g.server_count for g in self.srv_group)


def _get_bool(sec, key, default: bool) -> bool:
    raw = sec.get(key, None)
    if raw is None:
        return default
    return str(raw).strip().lower() in ("1", "true", "yes", "on")


def parse_config_file(path: str) -> SimConfig:
    """Parse a reference-format INI sim config
    (reference parse_config_file, config.cc:123-184)."""
    cp = configparser.ConfigParser()
    with open(path) as f:
        cp.read_file(f)

    g = cp["global"] if cp.has_section("global") else {}
    cfg = SimConfig(
        server_groups=int(g.get("server_groups", 1)),
        client_groups=int(g.get("client_groups", 1)),
        server_random_selection=_get_bool(g, "server_random_selection", False),
        server_soft_limit=_get_bool(g, "server_soft_limit", True),
        anticipation_timeout_s=float(g.get("anticipation_timeout", 0.0)),
        cli_group=[], srv_group=[])

    cfg.cli_group = []
    for i in range(cfg.client_groups):
        sec_name = f"client.{i}"
        sec = cp[sec_name] if cp.has_section(sec_name) else {}
        d = ClientGroup()
        cfg.cli_group.append(ClientGroup(
            client_count=int(sec.get("client_count", d.client_count)),
            client_wait_s=float(sec.get("client_wait", d.client_wait_s)),
            client_total_ops=int(sec.get("client_total_ops",
                                         d.client_total_ops)),
            client_server_select_range=int(sec.get(
                "client_server_select_range", d.client_server_select_range)),
            client_iops_goal=float(sec.get("client_iops_goal",
                                           d.client_iops_goal)),
            client_outstanding_ops=int(sec.get("client_outstanding_ops",
                                               d.client_outstanding_ops)),
            client_reservation=float(sec.get("client_reservation",
                                             d.client_reservation)),
            client_limit=float(sec.get("client_limit", d.client_limit)),
            client_weight=float(sec.get("client_weight", d.client_weight)),
            client_req_cost=int(sec.get("client_req_cost",
                                        d.client_req_cost)),
        ))

    cfg.srv_group = []
    for i in range(cfg.server_groups):
        sec_name = f"server.{i}"
        sec = cp[sec_name] if cp.has_section(sec_name) else {}
        d = ServerGroup()
        cfg.srv_group.append(ServerGroup(
            server_count=int(sec.get("server_count", d.server_count)),
            server_iops=float(sec.get("server_iops", d.server_iops)),
            server_threads=int(sec.get("server_threads", d.server_threads)),
        ))

    return cfg
