"""Developer / operations CLI — ``python -m erlvectordb_tpu_torch.cli <command>``.

Capability parity with the reference's dev tooling: dev_cli.erl (``status``,
``force-restart``, ``kill-existing``, ``help`` — src/dev_cli.erl:16-24) plus
the ops shell scripts (start-local.sh / stop-server.sh / check-status.sh):

  serve          start the full application (MCP + OAuth + REST + gRPC) on
                 the CUDA card (``--device cpu`` to serve from the CPU) and
                 block
  status         dev-mode info + port allocations + health (dev_cli status)
  check          probe a running instance's ports/health (check-status.sh)
  kill-existing  report ports in our ranges occupied by other processes
  bridge         run the stdio<->TCP MCP bridge (gemini_mcp_server.py)
  bench          refused: the port's card runs are chip_smoke.py and
                 compare_scans.py
  help           env-var documentation (dev_cli help :216-251)
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

from erlvectordb_tpu_torch.infra.config import load_config, startup_sequence


def cmd_serve(args) -> int:
    from erlvectordb_tpu_torch.app import Application

    cfg = load_config(config_file=args.config)
    app = Application(cfg, install_signals=True, device=args.device).start()
    ports = {name: app.service_port(name) for name in startup_sequence(cfg)}
    print(json.dumps({"status": "running", "ports": ports,
                      "development_mode": cfg.development_mode,
                      "container_mode": cfg.container_mode}))
    sys.stdout.flush()
    stop = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())
    except ValueError:
        pass
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    app.stop()
    return 0


def cmd_status(args) -> int:
    cfg = load_config(config_file=args.config)
    from erlvectordb_tpu_torch.infra.ports import probe_port

    info = {
        "development_mode": cfg.development_mode,
        "container_mode": cfg.container_mode,
        "services": {},
    }
    for name, svc in cfg.services.items():
        free = probe_port(svc.preferred_port, svc.bind_interface)
        info["services"][name] = {
            "preferred_port": svc.preferred_port,
            "port_range": list(svc.port_range),
            "bind_interface": svc.bind_interface,
            "startup_order": svc.startup_order,
            "required": svc.required,
            # occupied usually means a server instance is LISTENING there
            "port_state": "free" if free else "occupied",
        }
    print(json.dumps(info, indent=2))
    return 0


def cmd_check(args) -> int:
    """Probe a running instance (check-status.sh / test_server.sh analogue)."""
    import urllib.request

    cfg = load_config(config_file=args.config)
    results = {}
    ok = True
    for name in ("rest_api", "health_check"):
        svc = cfg.service(name)
        url = f"http://127.0.0.1:{svc.preferred_port}/health"
        try:
            with urllib.request.urlopen(url, timeout=2) as resp:
                results[name] = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001
            results[name] = {"error": str(e)}
            if name == "rest_api":
                ok = False
    from erlvectordb_tpu_torch.infra.startup import verify_tcp

    for name in ("mcp_server", "oauth_server"):
        svc = cfg.service(name)
        up = verify_tcp("127.0.0.1", svc.preferred_port)
        results[name] = {"tcp": "up" if up else "down",
                         "port": svc.preferred_port}
        ok = ok and up
    print(json.dumps({"ok": ok, "checks": results}, indent=2))
    return 0 if ok else 1


def cmd_kill_existing(args) -> int:
    cfg = load_config(config_file=args.config)
    if not cfg.development_mode:
        print(json.dumps({"error": "kill-existing requires dev mode "
                                   "(set EVDB_DEV_MODE=1)"}))
        return 1
    from erlvectordb_tpu_torch.infra.ports import PortManager

    pm = PortManager(cfg)
    occupied = pm.kill_existing_instances()
    print(json.dumps({"occupied_ports": occupied,
                      "note": "foreign processes are reported, never killed"}))
    return 0


def cmd_force_restart(args) -> int:
    """Dev-mode: stop the .evdb.pid instance (SIGTERM -> graceful shutdown),
    then start a fresh detached one (dev_cli force-restart analogue)."""
    import os
    import subprocess
    import time as _time

    cfg = load_config(config_file=args.config)
    if not cfg.development_mode:
        print(json.dumps({"error": "force-restart requires dev mode "
                                   "(set EVDB_DEV_MODE=1)"}))
        return 1
    pid_file = ".evdb.pid"
    if os.path.exists(pid_file):
        try:
            pid = int(open(pid_file).read().strip())
            os.kill(pid, signal.SIGTERM)
            for _ in range(30):
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    break
                _time.sleep(0.5)
        except (ValueError, ProcessLookupError, PermissionError):
            pass
        os.remove(pid_file)
    log = open(".evdb.log", "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "erlvectordb_tpu_torch.cli", "serve"],
        stdout=log, stderr=log, start_new_session=True,
    )
    open(pid_file, "w").write(str(proc.pid))
    print(json.dumps({"restarted": True, "pid": proc.pid}))
    return 0


def cmd_bridge(args) -> int:
    from erlvectordb_tpu_torch.serve.stdio_bridge import main as bridge_main

    bridge_main()
    return 0


def cmd_bench(args) -> int:
    """The JAX package's bench.py drives JAX, which the port never runs."""
    print(json.dumps({"error": "bench is not ported: the port's runs on the "
                               "card are chip_smoke.py and compare_scans.py"}))
    return 1


HELP_TEXT = """\
erlvectordb-tpu-torch environment variables (see infra/config.py):

  EVDB_CONFIG_FILE              path to a JSON config file
  EVDB_DEV_MODE=1               development mode (ports shift to 908x/909x)
  NODE_ENV=development          same
  CONTAINER=1 / DOCKER=1        container mode (bind 0.0.0.0, PORT override)
  PORT=<n>                      container-mode MCP port override
  BIND_ALL_INTERFACES=1         bind 0.0.0.0 everywhere
  GRACEFUL_SHUTDOWN_TIMEOUT=<s> total graceful-shutdown budget
  LOG_PORT_MAPPINGS=1           log every port binding

  MCP_SERVER_PORT / OAUTH_SERVER_PORT / REST_API_PORT / HEALTH_CHECK_PORT
  <SERVICE>_PORT_RANGE_START / <SERVICE>_PORT_RANGE_END
  <SERVICE>_BIND_INTERFACE / <SERVICE>_REQUIRED

serve --device cpu              serve from the CPU (default: the CUDA card)

stdio bridge (python -m erlvectordb_tpu_torch.serve.stdio_bridge):
  EVDB_HOST, EVDB_MCP_PORT, EVDB_OAUTH_URL, EVDB_CLIENT_ID,
  EVDB_CLIENT_SECRET, EVDB_AUTH_ENABLED, EVDB_TIMEOUT
  (ERLVECTORDB_* accepted as aliases)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="erlvectordb-tpu-torch")
    ap.add_argument("--config", help="path to JSON config file")
    sub = ap.add_subparsers(dest="command")
    serve = sub.add_parser("serve")
    serve.add_argument("--device",
                       help="device of the stores, e.g. cpu (default: the "
                            "CUDA card; without one, serve fails)")
    sub.add_parser("status")
    sub.add_parser("check")
    sub.add_parser("kill-existing")
    sub.add_parser("force-restart")
    sub.add_parser("bridge")
    sub.add_parser("bench")
    sub.add_parser("help")

    args = ap.parse_args(argv)
    if args.command == "serve":
        return cmd_serve(args)
    if args.command == "status":
        return cmd_status(args)
    if args.command == "check":
        return cmd_check(args)
    if args.command == "kill-existing":
        return cmd_kill_existing(args)
    if args.command == "force-restart":
        return cmd_force_restart(args)
    if args.command == "bridge":
        return cmd_bridge(args)
    if args.command == "bench":
        return cmd_bench(args)
    if args.command in ("help", None):
        print(HELP_TEXT)
        return 0
    ap.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
