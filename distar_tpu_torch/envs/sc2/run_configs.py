"""Version routing + platform run configs for launching SC2.

Counterpart of ``distar_tpu.envs.sc2.run_configs``.

Role parity with the reference run_configs (reference: distar/pysc2/
run_configs/lib.py:24-240, platforms.py:86-237, __init__.py:28-45) and the
decoder's BUILD2VERSION routing (distar/agent/default/replay_decoder.py:37-41):
resolve a game version string (or a replay's base_build) to the binary +
data-version to launch, find the install (SC2PATH), read map/replay data,
save replays.

VERSIONS is public Blizzard buildinfo
(github.com/Blizzard/s2client-proto/blob/master/buildinfo/versions.json) —
game facts, same data the reference vendors.
"""
from __future__ import annotations

import collections
import datetime
import os
import platform as _platform
import uuid
from typing import Dict, Optional

from . import sc_process

Version = collections.namedtuple(
    "Version", ["game_version", "build_version", "data_version", "binary"]
)


def version_dict(versions) -> Dict[str, Version]:
    return {ver.game_version: ver for ver in versions}


_V = Version
VERSIONS = version_dict([
    _V("3.16.1", 55958, "5BD7C31B44525DAB46E64C4602A81DC2", None),
    _V("3.17.0", 56787, "DFD1F6607F2CF19CB4E1C996B2563D9B", None),
    _V("3.17.1", 56787, "3F2FCED08798D83B873B5543BEFA6C4B", None),
    _V("3.17.2", 56787, "C690FC543082D35EA0AAA876B8362BEA", None),
    _V("3.18.0", 57507, "1659EF34997DA3470FF84A14431E3A86", None),
    _V("3.19.0", 58400, "2B06AEE58017A7DF2A3D452D733F1019", None),
    _V("3.19.1", 58400, "D9B568472880CC4719D1B698C0D86984", None),
    _V("4.0.0", 59587, "9B4FD995C61664831192B7DA46F8C1A1", None),
    _V("4.0.2", 59587, "B43D9EE00A363DAFAD46914E3E4AF362", None),
    _V("4.1.0", 60196, "1B8ACAB0C663D5510941A9871B3E9FBE", None),
    _V("4.1.1", 60321, "5C021D8A549F4A776EE9E9C1748FFBBC", None),
    _V("4.1.2", 60321, "33D9FE28909573253B7FC352CE7AEA40", None),
    _V("4.1.3", 60321, "F486693E00B2CD305B39E0AB254623EB", None),
    _V("4.1.4", 60321, "2E2A3F6E0BAFE5AC659C4D39F13A938C", None),
    _V("4.2.0", 62347, "C0C0E9D37FCDBC437CE386C6BE2D1F93", None),
    _V("4.2.1", 62848, "29BBAC5AFF364B6101B661DB468E3A37", None),
    _V("4.2.2", 63454, "3CB54C86777E78557C984AB1CF3494A0", None),
    _V("4.2.3", 63454, "5E3A8B21E41B987E05EE4917AAD68C69", None),
    _V("4.2.4", 63454, "7C51BC7B0841EACD3535E6FA6FF2116B", None),
    _V("4.3.0", 64469, "C92B3E9683D5A59E08FC011F4BE167FF", None),
    _V("4.3.1", 65094, "E5A21037AA7A25C03AC441515F4E0644", None),
    _V("4.3.2", 65384, "B6D73C85DFB70F5D01DEABB2517BF11C", None),
    _V("4.4.0", 65895, "BF41339C22AE2EDEBEEADC8C75028F7D", None),
    _V("4.4.1", 66668, "C094081D274A39219061182DBFD7840F", None),
    _V("4.5.0", 67188, "2ACF84A7ECBB536F51FC3F734EC3019F", None),
    _V("4.5.1", 67188, "6D239173B8712461E6A7C644A5539369", None),
    _V("4.6.0", 67926, "7DE59231CBF06F1ECE9A25A27964D4AE", None),
    _V("4.6.1", 67926, "BEA99B4A8E7B41E62ADC06D194801BAB", None),
    _V("4.6.2", 69232, "B3E14058F1083913B80C20993AC965DB", None),
    _V("4.7.0", 70154, "8E216E34BC61ABDE16A59A672ACB0F3B", None),
    _V("4.7.1", 70154, "94596A85191583AD2EBFAE28C5D532DB", None),
    _V("4.8.0", 71061, "760581629FC458A1937A05ED8388725B", None),
    _V("4.8.1", 71523, "FCAF3F050B7C0CC7ADCF551B61B9B91E", None),
    _V("4.8.2", 71663, "FE90C92716FC6F8F04B74268EC369FA5", None),
    _V("4.8.3", 72282, "0F14399BBD0BA528355FF4A8211F845B", None),
    _V("4.8.4", 73286, "CD040C0675FD986ED37A4CA3C88C8EB5", None),
    _V("4.8.5", 73559, "B2465E73AED597C74D0844112D582595", None),
    _V("4.8.6", 73620, "AA18FEAD6573C79EF707DF44ABF1BE61", None),
    _V("4.9.0", 74071, "70C74A2DCA8A0D8E7AE8647CAC68ACCA", None),
    _V("4.9.1", 74456, "218CB2271D4E2FA083470D30B1A05F02", None),
    _V("4.9.2", 74741, "614480EF79264B5BD084E57F912172FF", None),
    _V("4.9.3", 75025, "C305368C63621480462F8F516FB64374", None),
    _V("4.10.0", 75689, "B89B5D6FA7CBF6452E721311BFBC6CB2", None),
    _V("4.10.1", 75800, "DDFFF9EC4A171459A4F371C6CC189554", None),
    _V("4.10.2", 76052, "D0F1A68AA88BA90369A84CD1439AA1C3", None),
    _V("4.10.3", 76114, "CDB276D311F707C29BA664B7754A7293", None),
    _V("4.10.4", 76811, "FF9FA4EACEC5F06DEB27BD297D73ED67", None),
    _V("4.11.1", 77379, "F92D1127A291722120AC816F09B2E583", None),
    _V("4.11.2", 77535, "FC43E0897FCC93E4632AC57CBC5A2137", None),
    _V("4.11.3", 77661, "A15B8E4247434B020086354F39856C51", None),
    _V("4.11.4", 78285, "69493AFAB5C7B45DDB2F3442FD60F0CF", None),
    _V("4.12.0", 79998, "B47567DEE5DC23373BFF57194538DFD3", None),
    _V("4.12.1", 80188, "44DED5AED024D23177C742FC227C615A", None),
    _V("5.0.0", 80949, "9AE39C332883B8BF6AA190286183ED72", None),
    _V("5.0.1", 81009, "0D28678BC32E7F67A238F19CD3E0A2CE", None),
    _V("5.0.2", 81102, "DC0A1182FB4ABBE8E29E3EC13CF46F68", None),
    _V("5.0.3", 81433, "5FD8D4B6B52723B44862DF29F232CF31", None),
    _V("5.0.4", 82457, "D2707E265785612D12B381AF6ED9DBF4", None),
    _V("5.0.5", 82893, "D795328C01B8A711947CC62AA9750445", None),
    _V("5.0.6", 83830, "B4745D6A4F982A3143C183D8ACB6C3E3", None),
    _V("5.0.7", 84643, "A389D1F7DF9DD792FBE980533B7119FF", None),
    _V("5.0.8", 86383, "22EAC562CD0C6A31FB2C2C21E3AA3680", None),
    _V("5.0.9", 87702, "F799E093428D419FD634CCE9B925218C", None),
])

# build -> game version for replay routing; later point release wins for
# shared builds. The decoder's explicit pins (reference replay_decoder.py:
# 37-41) are applied on top.
BUILD2VERSION: Dict[int, str] = {}
for _ver in VERSIONS.values():
    BUILD2VERSION[_ver.build_version] = _ver.game_version
BUILD2VERSION.update({80188: "4.12.1", 81009: "5.0.0", 81433: "5.0.3"})


def version_for_build(base_build: int) -> Version:
    """Route a replay's base_build to a launchable Version (the decoder's
    BUILD2VERSION role). Unknown builds fall back to the closest known build
    at or below (the binary dirs are keyed by build)."""
    if base_build in BUILD2VERSION:
        return VERSIONS[BUILD2VERSION[base_build]]
    known = sorted(b for b in BUILD2VERSION)
    best = None
    for b in known:
        if b <= base_build:
            best = b
    if best is None:
        best = known[0]
    return VERSIONS[BUILD2VERSION[best]]


class RunConfig:
    """Base run config: directories + data access (reference lib.py:108-240)."""

    def __init__(self, replay_dir, data_dir, tmp_dir, version, cwd=None, env=None):
        self.replay_dir = replay_dir
        self.data_dir = data_dir
        self.tmp_dir = tmp_dir
        self.cwd = cwd
        self.env = env
        self.version = self._get_version(version)

    # ------------------------------------------------------------------ data
    def map_data(self, map_name: str, players: Optional[int] = None) -> bytes:
        """Map bytes by name or path; tries the (N)name player-count variant."""
        map_names = [map_name]
        if players:
            map_names.append(
                os.path.join(
                    os.path.dirname(map_name),
                    f"({players}){os.path.basename(map_name)}",
                )
            )
        for name in map_names:
            path = os.path.join(self.data_dir, "Maps", name)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    return f.read()
        # not in the install: fall back to the package's bundled ladder maps
        # (distar_tpu_torch/data/maps/...) so offline hosts play without installs;
        # match on normalized basenames (bundle files keep Blizzard's
        # punctuation, e.g. TurboCruise'84LE)
        from . import maps as map_registry

        def norm(s: str) -> str:
            return "".join(c for c in s.lower() if c.isalnum())

        bundle = map_registry.bundled_maps_dir()
        if os.path.isdir(bundle):
            by_norm = {
                norm(f[: -len(".SC2Map")]): f
                for f in os.listdir(bundle)
                if f.endswith(".SC2Map")
            }
            for name in map_names:
                stem = os.path.basename(name)
                if stem.endswith(".SC2Map"):
                    stem = stem[: -len(".SC2Map")]
                hit = by_norm.get(norm(stem))
                if hit:
                    with open(os.path.join(bundle, hit), "rb") as f:
                        return f.read()
        raise ValueError(f"Map '{map_name}' not found.")

    def abs_replay_path(self, replay_path: str) -> str:
        return os.path.join(self.replay_dir, replay_path)

    def replay_data(self, replay_path: str) -> bytes:
        with open(self.abs_replay_path(replay_path), "rb") as f:
            return f.read()

    def replay_paths(self, replay_dir: str):
        replay_dir = self.abs_replay_path(replay_dir)
        if replay_dir.lower().endswith(".sc2replay"):
            yield replay_dir
            return
        for f in os.listdir(replay_dir):
            if f.lower().endswith(".sc2replay"):
                yield os.path.join(replay_dir, f)

    def save_replay(self, replay_data: bytes, replay_dir: str, prefix=None) -> str:
        if not prefix:
            replay_filename = ""
        elif os.path.sep in prefix:
            raise ValueError(f"Prefix '{prefix}' contains '{os.path.sep}', use replay_dir instead.")
        else:
            replay_filename = prefix + "_"
        now = datetime.datetime.utcnow().replace(microsecond=0)
        replay_filename += "%s_%s.SC2Replay" % (
            now.isoformat("-").replace(":", "-"),
            str(uuid.uuid1()),
        )
        replay_dir = self.abs_replay_path(replay_dir)
        os.makedirs(replay_dir, exist_ok=True)
        replay_path = os.path.join(replay_dir, replay_filename)
        with open(replay_path, "wb") as f:
            f.write(replay_data)
        return replay_path

    # --------------------------------------------------------------- version
    def get_versions(self, containing: Optional[str] = None) -> Dict[str, Version]:
        if containing is not None and containing not in VERSIONS:
            raise ValueError(
                f"Unknown game version: {containing}. Known versions: "
                f"{sorted(VERSIONS.keys())}."
            )
        return VERSIONS

    def _get_version(self, game_version) -> Version:
        if isinstance(game_version, Version):
            if not game_version.game_version:
                raise ValueError(
                    f"Version '{game_version!r}' supplied without a game version."
                )
            if game_version.binary and game_version.build_version:
                return game_version
            game_version = game_version.game_version
        if game_version == "latest":
            return self._latest_installed_version()
        if game_version.count(".") == 1:
            game_version += ".0"
        return self.get_versions(containing=game_version)[game_version]

    def _latest_installed_version(self) -> Version:
        """Newest Versions/Base* under the install dir."""
        versions_dir = os.path.join(self.data_dir, "Versions")
        if os.path.isdir(versions_dir):
            builds = sorted(
                int(d[4:])
                for d in os.listdir(versions_dir)
                if d.startswith("Base") and d[4:].isdigit()
            )
            if builds:
                return version_for_build(builds[-1])
        # no install found; newest known (start() will raise a clear error)
        newest = max(VERSIONS.values(), key=lambda v: v.build_version)
        return newest

    def start(self, version=None, **kwargs):
        raise NotImplementedError


class LocalBase(RunConfig):
    """Run config for a public install (reference platforms.py:86-135)."""

    def __init__(self, base_dir, exec_name, version, cwd=None, env=None):
        base_dir = os.path.expanduser(base_dir)
        version = version or os.environ.get("DISTAR_SC2_VERSION") or "latest"
        cwd = cwd and os.path.join(base_dir, cwd)
        super().__init__(
            replay_dir=os.path.join(base_dir, "Replays"),
            data_dir=base_dir, tmp_dir=None, version=version, cwd=cwd, env=env,
        )
        if self.version.build_version < VERSIONS["3.16.1"].build_version:
            raise sc_process.SC2LaunchError(
                "SC2 Binaries older than 3.16.1 don't support the api."
            )
        self._exec_name = exec_name

    def exec_path(self) -> str:
        return os.path.join(
            self.data_dir,
            "Versions/Base%05d" % self.version.build_version,
            self._exec_name,
        )

    def start(self, version=None, want_rgb=False, **kwargs):
        del want_rgb
        if version:
            self.version = self._get_version(version)
        if not os.path.isdir(self.data_dir):
            raise sc_process.SC2LaunchError(
                f"Expected to find StarCraft II installed at '{self.data_dir}'. "
                "If it's not installed, do that and run it once so auto-detection "
                "works; if auto-detection fails, set the SC2PATH environment "
                "variable to the correct location."
            )
        exec_path = self.exec_path()
        if not os.path.exists(exec_path):
            raise sc_process.SC2LaunchError(f"No SC2 binary found at: {exec_path}")
        return sc_process.StarcraftProcess(
            self, exec_path=exec_path, version=self.version, **kwargs
        )


class Linux(LocalBase):
    """Linux install (headless SC2): SC2PATH or ~/StarCraftII."""

    def __init__(self, version=None):
        base_dir = os.environ.get("SC2PATH", "~/StarCraftII")
        env = dict(os.environ)
        # the Linux binary needs its libs (reference platforms.py Linux cfg)
        env["SC2_BASE_DIR"] = os.path.expanduser(base_dir)
        super().__init__(base_dir, "SC2_x64", version=version, cwd="Support64", env=env)


class Windows(LocalBase):
    def __init__(self, version=None):
        base_dir = os.environ.get("SC2PATH", "C:/Program Files (x86)/StarCraft II")
        super().__init__(base_dir, "SC2_x64.exe", version=version, cwd="Support64")


class MacOS(LocalBase):
    def __init__(self, version=None):
        base_dir = os.environ.get("SC2PATH", "/Applications/StarCraft II")
        super().__init__(base_dir, "SC2.app/Contents/MacOS/SC2", version=version)


def get(version=None) -> RunConfig:
    """Platform-routed run config (reference run_configs/__init__.py:28-45)."""
    system = _platform.system()
    if system == "Linux":
        return Linux(version=version)
    if system == "Windows":
        return Windows(version=version)
    if system == "Darwin":
        return MacOS(version=version)
    raise ValueError(f"Unsupported platform: {system}")
