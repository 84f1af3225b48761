"""Image families + bootstrap generation — the amifamily subsystem analog.

The port's own copy of `karpenter_tpu/cloud/image.py`, unchanged in
semantics.

Reference: pkg/providers/amifamily/ — an `AMIFamily` strategy interface
with per-OS implementations (AL2, AL2023, Bottlerocket, Windows, Custom;
resolver.go:88-110), image resolution from aliases (`al2023@latest` → SSM
parameter), explicit IDs, or tag selectors (ami.go:86-166), newest-first
sort, arch-based mapping to instance types, and bootstrap userdata
generators (eksbootstrap.sh args, nodeadm YAML, Bottlerocket TOML, MIME
multipart merge — pkg/providers/amifamily/bootstrap/).

Ours: an `ImageFamily` strategy registry with three stock families
(standard = cloud-init shell, declarative = YAML node config, minimal =
TOML settings — the same three bootstrap *shapes* the reference ships),
alias/selector resolution against the cloud's image catalog, and MIME
merge of user-supplied userdata.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence

from ..models import labels as L
from ..models.nodepool import NodeClassSpec
from ..models.pod import Taint
from ..models.resources import Resources


@dataclass
class Image:
    id: str
    name: str
    family: str            # standard | declarative | minimal
    arch: str              # amd64 | arm64
    created_at: float
    deprecated: bool = False
    tags: Dict[str, str] = field(default_factory=dict)

    def requirements_arch(self) -> str:
        return self.arch


@dataclass
class BootstrapConfig:
    cluster_name: str
    cluster_endpoint: str
    labels: Dict[str, str]
    taints: List[Taint]
    kubelet_max_pods: Optional[int]
    kube_reserved: Dict[str, str]
    custom_user_data: str = ""


class ImageFamily(Protocol):
    name: str

    def user_data(self, cfg: BootstrapConfig) -> str: ...


class StandardFamily:
    """Shell bootstrap (the eksbootstrap.sh-args shape)."""

    name = "standard"

    def user_data(self, cfg: BootstrapConfig) -> str:
        taints = ",".join(f"{t.key}={t.value}:{t.effect}" for t in cfg.taints)
        labels = ",".join(f"{k}={v}" for k, v in sorted(cfg.labels.items()))
        # ONE command, continuations derived from the arg list — the old
        # hand-written lines dropped the backslash before an appended
        # --max-pods, leaving it outside the bootstrap invocation (found
        # by the golden-userdata tests)
        args = [f"--cluster '{cfg.cluster_name}'",
                f"--endpoint '{cfg.cluster_endpoint}'",
                f"--node-labels '{labels}'",
                f"--register-taints '{taints}'"]
        if cfg.kubelet_max_pods is not None:
            args.append(f"--max-pods {cfg.kubelet_max_pods}")
        body = ("#!/bin/bash -xe\n/etc/node/bootstrap.sh "
                + " \\\n  ".join(args))
        if cfg.custom_user_data:
            return merge_mime([cfg.custom_user_data, body])
        return body


class DeclarativeFamily:
    """YAML node-config bootstrap (the AL2023 nodeadm shape)."""

    name = "declarative"

    def user_data(self, cfg: BootstrapConfig) -> str:
        out = [
            "apiVersion: node.karpenter.tpu/v1",
            "kind: NodeConfig",
            "spec:",
            "  cluster:",
            f"    name: {cfg.cluster_name}",
            f"    endpoint: {cfg.cluster_endpoint}",
            "  kubelet:",
        ]
        if cfg.kubelet_max_pods is not None:
            out.append(f"    maxPods: {cfg.kubelet_max_pods}")
        if cfg.labels:
            out.append("    nodeLabels:")
            for k, v in sorted(cfg.labels.items()):
                out.append(f"      {k}: '{v}'")
        if cfg.taints:
            out.append("    registerWithTaints:")
            for t in cfg.taints:
                out.append(f"      - key: {t.key}")
                out.append(f"        value: '{t.value}'")
                out.append(f"        effect: {t.effect}")
        body = "\n".join(out)
        if cfg.custom_user_data:
            return merge_mime([cfg.custom_user_data, body])
        return body


class MinimalFamily:
    """TOML settings bootstrap (the Bottlerocket shape — no shell at all)."""

    name = "minimal"

    def user_data(self, cfg: BootstrapConfig) -> str:
        out = [
            "[settings.kubernetes]",
            f'cluster-name = "{cfg.cluster_name}"',
            f'api-server = "{cfg.cluster_endpoint}"',
        ]
        if cfg.kubelet_max_pods is not None:
            out.append(f"max-pods = {cfg.kubelet_max_pods}")
        if cfg.labels:
            out.append("[settings.kubernetes.node-labels]")
            for k, v in sorted(cfg.labels.items()):
                out.append(f'"{k}" = "{v}"')
        if cfg.taints:
            out.append("[settings.kubernetes.node-taints]")
            for t in cfg.taints:
                out.append(f'"{t.key}" = "{t.value}:{t.effect}"')
        # minimal family ignores custom shell userdata (like Bottlerocket)
        return "\n".join(out)


class ImperativeFamily:
    """Imperative script-block bootstrap — the Windows analog (reference
    amifamily/windows.go:40): a different script dialect, custom
    userdata PREPENDED inside the same script block (Windows appends
    into the <powershell> section rather than MIME-merging), and
    amd64-only images. Proves the strategy registry extends past the
    three stock shapes."""

    name = "imperative"

    def user_data(self, cfg: BootstrapConfig) -> str:
        taints = ",".join(f"{t.key}={t.value}:{t.effect}" for t in cfg.taints)
        labels = ",".join(f"{k}={v}" for k, v in sorted(cfg.labels.items()))
        # ONE command: every flag must reach the same Register-Node
        # invocation (a bare-newline split would orphan the flags)
        cmd = (f"Register-Node -Cluster '{cfg.cluster_name}'"
               f" -Endpoint '{cfg.cluster_endpoint}'"
               f" -NodeLabels '{labels}' -Taints '{taints}'")
        if cfg.kubelet_max_pods is not None:
            cmd += f" -MaxPods {cfg.kubelet_max_pods}"
        script = cmd
        if cfg.custom_user_data:
            # same block, user content first (windows.go UserData merge)
            script = cfg.custom_user_data + "\n" + script
        return f"<script>\n{script}\n</script>"


FAMILIES: Dict[str, ImageFamily] = {
    f.name: f for f in (StandardFamily(), DeclarativeFamily(),
                        MinimalFamily(), ImperativeFamily())
}


def merge_mime(parts: Sequence[str]) -> str:
    """MIME multipart merge of userdata documents (reference
    bootstrap/mime/mime.go)."""
    boundary = "//KARPENTER-TPU-BOUNDARY"
    out = [f'Content-Type: multipart/mixed; boundary="{boundary[2:]}"',
           "MIME-Version: 1.0", ""]
    for p in parts:
        ctype = "text/x-shellscript" if p.startswith("#!") else "text/plain"
        out += [boundary, f'Content-Type: {ctype}; charset="us-ascii"', "", p, ""]
    out.append(boundary + "--")
    return "\n".join(out)


class ImageProvider:
    """Image discovery: alias ('standard@latest', 'standard@v1.2'),
    explicit ids, or tag selectors; newest-first (reference ami.go:70,
    types.go:48).

    Constructed either from a static snapshot (tests) or a live `lister`
    with a TTL — the stale-alias invalidation analog (reference
    providers/ssm/invalidation/controller.go:55 drops cached SSM AMI
    params so an alias repoint takes effect without an operator
    restart). invalidate() forces the next resolve to re-list; the
    catalog refresh controller calls it each cycle, so a repoint lands
    within one refresh period."""

    def __init__(self, images: Optional[Sequence[Image]] = None,
                 lister=None, clock=None, ttl: float = 300.0):
        self._static = list(images) if images is not None else []
        self._lister = lister
        self._clock = clock
        self._ttl = ttl
        self._cached: Optional[List[Image]] = None
        self._fetched_at = float("-inf")

    @property
    def _images(self) -> List[Image]:
        if self._lister is None:
            return self._static
        now = self._clock.now() if self._clock is not None else 0.0
        if self._cached is None or now - self._fetched_at >= self._ttl:
            self._cached = list(self._lister())
            self._fetched_at = now
        return self._cached

    def invalidate(self) -> None:
        """Drop the cached listing; next resolve re-reads the cloud."""
        self._fetched_at = float("-inf")

    def resolve(self, nc: NodeClassSpec) -> List[Image]:
        sel = nc.image_selector
        live = [i for i in self._images if not i.deprecated]
        if "alias" in sel:
            fam, _, version = sel["alias"].partition("@")
            pool = [i for i in live if i.family == fam]
            if version and version != "latest":
                pool = [i for i in pool if i.name.endswith(version)]
            else:
                pool = sorted(pool, key=lambda i: -i.created_at)
                # latest per arch
                seen, out = set(), []
                for i in pool:
                    if i.arch not in seen:
                        seen.add(i.arch)
                        out.append(i)
                return out
            return sorted(pool, key=lambda i: -i.created_at)
        if "ids" in sel:
            ids = set(sel["ids"].split(","))
            return [i for i in self._images if i.id in ids]  # ids may pin deprecated
        if sel:  # tag selectors
            out = [i for i in live
                   if all(i.tags.get(k) == v for k, v in sel.items())]
            return sorted(out, key=lambda i: -i.created_at)
        # default: latest of the nodeclass's family
        return self.resolve(NodeClassSpec(
            name=nc.name, image_selector={"alias": f"{nc.image_family}@latest"}))

    def for_arch(self, images: List[Image], arch: str) -> Optional[Image]:
        for i in images:
            if i.arch == arch:
                return i
        return None


def default_images(clock_now: float = 0.0) -> List[Image]:
    """The fake cloud's image catalog."""
    out = []
    for fam in ("standard", "declarative", "minimal", "imperative"):
        # imperative images are amd64-only, like the reference's Windows
        # AMIs (windows.go)
        for arch in (("amd64",) if fam == "imperative"
                     else ("amd64", "arm64")):
            for ver, age in (("v1.30.1", 3000.0), ("v1.31.0", 2000.0),
                             ("v1.32.0", 1000.0)):
                short = hashlib.sha256(f"{fam}{arch}{ver}".encode()).hexdigest()[:8]
                out.append(Image(
                    id=f"img-{short}", name=f"{fam}-{arch}-{ver}",
                    family=fam, arch=arch,
                    created_at=clock_now - age,
                    tags={"family": fam, "arch": arch, "version": ver}))
    return out
